"""java.util.Random-compatible LCG.

MinHashLSH generates its random hash coefficients with `new Random(seed)` +
`nextInt(bound)` (feature/lsh/MinHashLSHModelData.java:generateModelData),
so model data written by the reference only matches ours if the RNG stream
matches. java.util.Random's algorithm is publicly specified (a 48-bit LCG).
"""

from __future__ import annotations

_MULT = 0x5DEECE66D
_ADD = 0xB
_MASK = (1 << 48) - 1


class JavaRandom:
    def __init__(self, seed: int):
        self._seed = (seed ^ _MULT) & _MASK

    def _next(self, bits: int) -> int:
        self._seed = (self._seed * _MULT + _ADD) & _MASK
        value = self._seed >> (48 - bits)
        # interpret as signed 32-bit when bits == 32
        if bits == 32 and value >= (1 << 31):
            value -= 1 << 32
        return value

    def next_int(self, bound: int = None) -> int:
        if bound is None:
            return self._next(32)
        if bound <= 0:
            raise ValueError("bound must be positive")
        if (bound & -bound) == bound:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):
                return val

    def next_double(self) -> float:
        return ((self._next(26) << 27) + self._next(27)) / float(1 << 53)

    def next_long(self) -> int:
        hi = self._next(32)
        lo = self._next(32)
        # Wrap to signed 64-bit the way Java overflow does (hi =
        # Integer.MIN_VALUE with negative lo would otherwise escape the
        # long range as an unbounded Python int).
        v = ((hi << 32) + lo) & ((1 << 64) - 1)
        return v - (1 << 64) if v >= (1 << 63) else v
