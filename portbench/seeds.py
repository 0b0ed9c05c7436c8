"""Seeds of one run: every draw of a run comes from `--seed` and the name
of what is drawn, so the same seed gives the same tables, orders and
samples, and a seed past 32 bits is used whole."""

from __future__ import annotations

import hashlib
import random

import torch


def derive(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of run `seed`."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    """A torch generator on `device` for the stream `name`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, name))
    return gen


def host_random(seed: int, name: str) -> random.Random:
    """A host generator for the stream `name` (orders and samples)."""
    return random.Random(derive(seed, name))
