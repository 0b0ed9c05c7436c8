"""Device ops over dictionary-encoded token columns.

Port of flink_ml_tpu/ops/tokens.py: the compute behind the string stages
when a column is a `DictTokenMatrix` (a host vocabulary and an (n, k) int32
id matrix, -1 = absent token). The reference runs these as per-row Java
map operators over String[] values (CountVectorizer.java,
HashingTF.java:125-185, NGram.java, StopWordsRemover.java); here they are
bincounts, row sorts, gathers and scatters on the id matrix.

The outputs equal the JAX package's exactly, layout included: a term-count
batch lists each row's distinct terms ascending with -1 padding on the
right, float32 counts, and is `min(k, V)` slots wide when the output
vocabulary has V <= DENSE_COUNT_MAX_TERMS terms and (k + 1) * V < 2^31 (the
JAX package's dense-count form), else k wide. The strategy is not the JAX
package's: its chunked loops choose among gather-free forms (preimage
compare-reduce, compare-map, dense counts, a drop-set sweep) because a
gather is slow on the TPU; a gather is cheap on the card, so every loop
here is one gather, one row sort and one scatter a chunk.

Host id matrices are staged to `config.device()` a chunk at a time;
tensor ids compute on their own device. Chunks of CHUNK_ROWS rows bound
the transients (a row sort returns int64 indices: 8 bytes a token), and
the chunks write into preallocated outputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import config
from ..parallel.prefetch import to_device

CHUNK_ROWS = 1_000_000
DENSE_COUNT_MAX_TERMS = 512
#: below this many u^gram combinations NGram builds the whole joined
#: vocabulary on the host; above it only the observed codes decode
NGRAM_EAGER_VOCAB_MAX = 65_536
_BIG = 2**31 - 1


def _device_of(ids) -> torch.device:
    return ids.device if isinstance(ids, torch.Tensor) else config.device()


def _chunk(ids, start: int, stop: int, device: torch.device) -> torch.Tensor:
    """Rows [start, stop) of a host or tensor id matrix, as int32 on `device`."""
    part = ids[start:stop]
    if isinstance(part, torch.Tensor):
        return part.to(torch.int32)
    return to_device(np.asarray(part), device, torch.int32)


def _staged(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return to_device(x, device, dtype)
    return to_device(np.asarray(x), device, dtype)


def term_counts(ids: torch.Tensor, num_terms: int) -> torch.Tensor:
    """(2, num_terms) int64: the corpus term frequency and the document
    frequency (rows holding the term) of each id; -1 and ids outside
    [0, num_terms) are not counted. df counts the first of each run of a
    row sort (CountVectorizer.java's fit aggregation)."""
    # kept int32 (the chunk's dtype): the row sort moves half the bytes of int64
    safe = torch.where((ids >= 0) & (ids < num_terms), ids, num_terms)
    tf = torch.bincount(safe.reshape(-1).long(), minlength=num_terms + 1)[:num_terms]
    S = torch.sort(safe, dim=1).values
    first = torch.ones_like(S, dtype=torch.bool)
    first[:, 1:] = S[:, 1:] != S[:, :-1]
    df = torch.bincount(torch.where(first, S, num_terms).reshape(-1).long(),
                        minlength=num_terms + 1)[:num_terms]
    return torch.stack([tf, df])


def term_counts_chunked(ids, num_terms: int, chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """`term_counts` over row chunks, summed on the device."""
    device = _device_of(ids)
    n = ids.shape[0]
    total = torch.zeros((2, num_terms), dtype=torch.int64, device=device)
    for s in range(0, n, chunk_rows):
        total += term_counts(_chunk(ids, s, min(n, s + chunk_rows), device), num_terms)
    return total


def row_term_runs(mapped: torch.Tensor, thr_row: torch.Tensor,
                  binary: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (term, count) runs of a mapped id matrix as padded CSR, (n, k)
    wide: each row's distinct non-negative terms ascending with their
    counts (1 when `binary`), runs whose count is under thr_row[row]
    dropped (minTF), -1 and 0 padding on the right. One row sort; a run's
    length is the distance to the next run start (a reversed cumulative
    min); the kept runs scatter left in order."""
    n, k = mapped.shape
    S = torch.sort(torch.where(mapped >= 0, mapped, _BIG), dim=1).values
    pos = torch.arange(k, device=mapped.device, dtype=torch.int32).expand(n, k)
    first = torch.ones_like(S, dtype=torch.bool)
    first[:, 1:] = S[:, 1:] != S[:, :-1]
    first_pos = torch.where(first, pos, k)
    next_first = torch.full_like(first_pos, k)
    if k > 1:
        next_first[:, :-1] = torch.cummin(first_pos.flip(1), dim=1).values.flip(1)[:, 1:]
    runlen = next_first - pos
    kept = first & (S != _BIG) & (runlen.to(torch.float32) >= thr_row[:, None])
    slot = torch.where(kept, torch.cumsum(kept, dim=1, dtype=torch.int32) - 1, k).long()
    indices = torch.full((n, k + 1), -1, dtype=torch.int32, device=mapped.device)
    values = torch.zeros((n, k + 1), dtype=torch.float32, device=mapped.device)
    indices.scatter_(1, slot, torch.where(kept, S, -1))
    counts = torch.ones_like(runlen) if binary else runlen
    values.scatter_(1, slot, torch.where(kept, counts, 0).to(torch.float32))
    return indices[:, :k], values[:, :k]


def row_term_counts_dense(mapped: torch.Tensor, thr_row: torch.Tensor, num_terms: int,
                          binary: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """`row_term_runs` of ids mapped into [0, num_terms), cut to the
    min(k, num_terms) slots a row can fill: the layout of the JAX
    package's small-vocabulary form (its broadcast compare and packed
    sort), computed by the same row sort as every other width."""
    indices, values = row_term_runs(mapped, thr_row, binary)
    width = min(mapped.shape[1], num_terms)
    return indices[:, :width], values[:, :width]


def gather_map(ids: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Map ids through a lookup table; -1 stays -1 (absent or out of vocabulary)."""
    if lut.numel() == 0:  # an empty vocabulary: every id is -1 already
        return torch.full_like(ids, -1)
    valid = ids >= 0
    return torch.where(valid, lut[torch.where(valid, ids, 0).long()], -1)


def lut_preimage(lut, num_terms: int) -> Optional[torch.Tensor]:
    """pre[v] = the unique dictionary id d with lut[d] == v, -2 if none,
    as int32 on the lut's device (a host lut: the CPU); None if the lut is
    not injective on its non-negative range (hash collisions, e.g. HashingTF
    buckets) or maps outside the `num_terms` output vocabulary. The JAX
    package's gather-free count form reads it; the port maps with a gather
    (the module docstring), so none of its paths calls it."""
    lut = lut if isinstance(lut, torch.Tensor) else torch.from_numpy(np.asarray(lut))
    valid = lut >= 0
    targets = lut[valid].long()
    if targets.numel() and int(targets.max()) >= num_terms:
        return None
    if torch.unique(targets).numel() != targets.numel():
        return None
    pre = torch.full((int(num_terms),), -2, dtype=torch.int32, device=lut.device)
    pre[targets] = torch.nonzero(valid).flatten().to(torch.int32)
    return pre


def term_runs_width(k: int, num_terms: Optional[int]) -> int:
    """The JAX package's padded width of a term-count batch: min(k, V) in
    its dense-count form (V <= DENSE_COUNT_MAX_TERMS, (k + 1) * V < 2^31),
    else k."""
    dense = (num_terms is not None and num_terms <= DENSE_COUNT_MAX_TERMS
             and (k + 1) * int(num_terms) < 2**31)
    return min(int(num_terms), k) if dense else k


def map_term_runs_chunked(ids, lut, thr_row, binary: bool = False,
                          chunk_rows: int = CHUNK_ROWS,
                          num_terms: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """lut-map each id, then `row_term_runs`, a chunk of rows at a time,
    into preallocated (n, term_runs_width) int32 indices and float32
    values on the ids' device. A row holds at most min(k, V) distinct
    terms, so the narrower width only cuts padding."""
    device = _device_of(ids)
    n, k = ids.shape
    width = term_runs_width(k, num_terms)
    lut = _staged(lut, torch.int32, device)
    thr_row = _staged(thr_row, torch.float32, device)
    indices = torch.empty((n, width), dtype=torch.int32, device=device)
    values = torch.empty((n, width), dtype=torch.float32, device=device)
    for s in range(0, n, chunk_rows):
        e = min(n, s + chunk_rows)
        pi, pv = row_term_runs(gather_map(_chunk(ids, s, e, device), lut), thr_row[s:e], binary)
        indices[s:e], values[s:e] = pi[:, :width], pv[:, :width]
    return indices, values


def filter_tokens(ids: torch.Tensor, keep_vocab: torch.Tensor) -> torch.Tensor:
    """Drop the tokens whose vocabulary entry is masked out (StopWordsRemover):
    the kept ids move left in their order, -1 fills the right."""
    n, k = ids.shape
    valid = ids >= 0
    keep = valid & keep_vocab[torch.where(valid, ids, 0).long()]
    slot = torch.where(keep, torch.cumsum(keep, dim=1, dtype=torch.int32) - 1, k).long()
    out = torch.full((n, k + 1), -1, dtype=torch.int32, device=ids.device)
    out.scatter_(1, slot, torch.where(keep, ids.to(torch.int32), -1))
    return out[:, :k]


def filter_tokens_chunked(ids, keep_vocab, chunk_rows: int = CHUNK_ROWS) -> torch.Tensor:
    """`filter_tokens` over row chunks into a preallocated output. A host
    mask that keeps every entry returns the ids unchanged, with no copy
    (as the JAX package does)."""
    device = _device_of(ids)
    if isinstance(keep_vocab, np.ndarray) and bool(keep_vocab.all()):
        return ids if isinstance(ids, torch.Tensor) else _staged(ids, torch.int32, device)
    keep_vocab = _staged(keep_vocab, torch.bool, device)
    n, k = ids.shape
    out = torch.empty((n, k), dtype=torch.int32, device=device)
    for s in range(0, n, chunk_rows):
        e = min(n, s + chunk_rows)
        out[s:e] = filter_tokens(_chunk(ids, s, e, device), keep_vocab)
    return out


def ngram_codes(ids, num_terms: int, gram: int) -> torch.Tensor:
    """Adjacent ids as base-`num_terms` n-gram codes, int32 (exact while
    num_terms ** gram < 2^31, which the caller checks):
    code = ids[j] * u^(g-1) + ... + ids[j+g-1]; a window with an absent
    component gives -1 (NGram.java: an input shorter than n gives none)."""
    ids = _staged(ids, torch.int32, _device_of(ids))
    n, k = ids.shape
    out_k = k - gram + 1
    code = torch.zeros((n, out_k), dtype=torch.int32, device=ids.device)
    valid = torch.ones((n, out_k), dtype=torch.bool, device=ids.device)
    for t in range(gram):
        part = ids[:, t:t + out_k]
        valid &= part >= 0
        code = code * num_terms + torch.where(part >= 0, part, 0)
    return torch.where(valid, code, -1)


def ngram_vocab_full(vocab: np.ndarray, gram: int) -> np.ndarray:
    """All u^gram space-joined combinations in code order (host numpy, as
    the JAX package builds them)."""
    if len(vocab) == 0:
        return np.zeros(0, dtype="<U1")
    grams = vocab.astype(object)
    for _ in range(gram - 1):
        grams = np.char.add(
            np.char.add(grams[:, None].astype(str), " "), vocab[None, :].astype(str)
        ).ravel()
        grams = grams.astype(object)
    width = (np.char.str_len(vocab.astype(str)).max() + 1) * gram
    return grams.astype(f"<U{width}")


def ngram_vocab_observed(vocab: np.ndarray, gram: int,
                         codes: torch.Tensor) -> Tuple[np.ndarray, torch.Tensor]:
    """The n-gram vocabulary of the codes that occur, and the codes
    reindexed to it: the distinct codes come from one sorted `torch.unique`
    on the device (one readback), each code's rank from a search of them;
    only the observed codes decode to strings. -1 stays -1."""
    u = len(vocab)
    # tpulint: disable=host-sync-leak -- the observed codes' one readback
    uniq_host = torch.unique(codes, sorted=True).cpu().numpy()
    uniq_host = uniq_host[uniq_host >= 0]
    uniq = to_device(uniq_host, codes.device, torch.int32)
    n = codes.shape[0]
    remapped = torch.empty_like(codes)
    for s in range(0, n, CHUNK_ROWS):
        part = codes[s:s + CHUNK_ROWS]
        ranks = torch.searchsorted(uniq, part.contiguous()).to(torch.int32)
        remapped[s:s + CHUNK_ROWS] = torch.where(part >= 0, ranks, -1)
    if uniq_host.size == 0:
        return np.zeros(0, dtype="<U1"), remapped
    powers = u ** np.arange(gram - 1, -1, -1, dtype=np.int64)
    digits = (uniq_host[:, None].astype(np.int64) // powers) % u
    terms = vocab.astype(str)[digits]
    joined = terms[:, 0]
    for t in range(1, gram):
        joined = np.char.add(np.char.add(joined, " "), terms[:, t])
    return joined, remapped


def random_token_ids(seed: int, n: int, k: int, num_terms: int,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """A seeded (n, k) int32 id matrix born on the device, uniform over
    [0, num_terms) (the benchmark's data generator). Its bits are torch's
    generator's, not jax.random's."""
    device = config.device() if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, num_terms, (n, k), generator=gen, device=device, dtype=torch.int32)
