"""Guava-compatible MurmurHash3 (32-bit, seed 0) for the hashing trick.

A copy of flink_ml_tpu/utils/hashing.py (host-only numpy and Python; the
port keeps its own). The reference hashes terms with guava's murmur3_32(0)
(feature/hashingtf/HashingTF.java:45,60-61,160-185: hashUnencodedChars for
String, hashInt/hashLong for numerics), re-implemented from the public
MurmurHash3 spec so hashed feature indices match the reference exactly.
"""

from __future__ import annotations

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _mix_k1(k1: int) -> int:
    k1 = (k1 * _C1) & _M
    k1 = _rotl(k1, 15)
    return (k1 * _C2) & _M


def _mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = _rotl(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _M


def _fmix(h1: int, length: int) -> int:
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M
    h1 ^= h1 >> 16
    return h1


def _to_signed(x: int) -> int:
    return x - (1 << 32) if x >= (1 << 31) else x


def murmur3_hash_int(value: int, seed: int = 0) -> int:
    """guava Murmur3_32.hashInt: one 4-byte block."""
    h1 = _mix_h1(seed & _M, _mix_k1(value & _M))
    return _to_signed(_fmix(h1, 4))


def murmur3_hash_long(value: int, seed: int = 0) -> int:
    """guava Murmur3_32.hashLong: low int then high int."""
    value &= 0xFFFFFFFFFFFFFFFF
    low = value & _M
    high = (value >> 32) & _M
    h1 = _mix_h1(seed & _M, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _to_signed(_fmix(h1, 8))


def murmur3_hash_unencoded_chars(s: str, seed: int = 0) -> int:
    """guava Murmur3_32.hashUnencodedChars: UTF-16 code units, 2 per block."""
    # Java strings are UTF-16: astral chars must become surrogate pairs.
    units = []
    for c in s:
        cp = ord(c)
        if cp > 0xFFFF:
            cp -= 0x10000
            units.append(0xD800 + (cp >> 10))
            units.append(0xDC00 + (cp & 0x3FF))
        else:
            units.append(cp)
    h1 = seed & _M
    for i in range(0, len(units) - 1, 2):
        k1 = units[i] | (units[i + 1] << 16)
        h1 = _mix_h1(h1, _mix_k1(k1))
    if len(units) % 2 == 1:
        h1 ^= _mix_k1(units[-1])
    return _to_signed(_fmix(h1, 2 * len(units)))


def hash_term(obj, seed: int = 0) -> int:
    """Dispatch by type like HashingTF.hash (HashingTF.java:160-185)."""
    import struct

    if obj is None:
        return 0
    if isinstance(obj, bool):
        return murmur3_hash_int(1 if obj else 0, seed)
    if isinstance(obj, int):
        if -(2**31) <= obj < 2**31:
            return murmur3_hash_int(obj, seed)
        return murmur3_hash_long(obj, seed)
    if isinstance(obj, float):
        bits = struct.unpack("<q", struct.pack("<d", obj))[0]
        return murmur3_hash_long(bits, seed)
    if isinstance(obj, str):
        return murmur3_hash_unencoded_chars(obj, seed)
    raise TypeError(f"Unsupported term type {type(obj).__name__} for hashing")


def murmur3_batch_unencoded_chars(strings, seed: int = 0):
    """Vectorized guava Murmur3_32.hashUnencodedChars over a unicode array.

    Operates on numpy fixed-width unicode (UTF-32 view = UTF-16 code units
    for BMP text, which covers the ASCII `col=value` strings FeatureHasher
    produces); strings containing astral characters fall back to the scalar
    path. Arithmetic runs in uint64 with explicit 32-bit masking — a Python
    per-string loop over the benchmark's 30M strings is minutes on this
    single-core host, this is a few vector passes.
    Returns signed int32 hashes identical to `murmur3_hash_unencoded_chars`.
    """
    import numpy as np

    S = np.asarray(strings)
    if S.dtype.kind != "U":
        was_object = S.dtype == object
        S = S.astype(str)
        if was_object:
            # numpy U storage strips TRAILING U+0000, so such strings can't
            # round-trip the vectorized layout (Java hashes them). Detect
            # via python len (O(1) per string, no char scan) vs the stored
            # width and hash per-row if any row lost characters. Non-str
            # objects render via str() and can't contain NULs.
            src = np.asarray(strings, dtype=object)
            py_lens = np.fromiter(
                (len(s) if isinstance(s, str) else -1 for s in src),
                np.int64,
                count=len(src),
            )
            if (py_lens > np.char.str_len(S)).any():
                return np.asarray(
                    [murmur3_hash_unencoded_chars(str(s), seed) for s in src],
                    np.int64,
                )
    n = S.shape[0]
    M = S.dtype.itemsize // 4
    if M == 0:
        return np.full(n, _to_signed(_fmix(seed & _M, 0)), np.int64)
    U = np.ascontiguousarray(S).view(np.uint32).reshape(n, M).astype(np.uint64)
    if (U > 0xFFFF).any():  # astral chars need surrogate-pair splitting
        return np.asarray(
            [murmur3_hash_unencoded_chars(str(s), seed) for s in S], np.int64
        )
    # length = last nonzero + 1: zeros BEFORE it are real embedded U+0000
    # characters (Java hashes them); numpy cannot represent trailing ones.
    nz = U != 0
    lens = (M - np.argmax(nz[:, ::-1], axis=1)).astype(np.int64)
    lens[~nz.any(axis=1)] = 0

    MASK = np.uint64(_M)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & MASK

    def mix_k1(k1):
        k1 = (k1 * np.uint64(_C1)) & MASK
        k1 = rotl(k1, 15)
        return (k1 * np.uint64(_C2)) & MASK

    def mix_h1(h1, k1):
        h1 = h1 ^ k1
        h1 = rotl(h1, 13)
        return (h1 * np.uint64(5) + np.uint64(0xE6546B64)) & MASK

    h1 = np.full(n, seed & _M, np.uint64)
    nblocks = lens // 2
    for b in range(M // 2):
        k1 = (U[:, 2 * b] | (U[:, 2 * b + 1] << np.uint64(16))) & MASK
        h1 = np.where(b < nblocks, mix_h1(h1, mix_k1(k1)), h1)
    odd = (lens % 2) == 1
    last = U[np.arange(n), np.maximum(lens - 1, 0)]
    h1 = np.where(odd, h1 ^ mix_k1(last), h1)

    h1 = h1 ^ (np.uint64(2) * lens.astype(np.uint64))
    h1 = (h1 ^ (h1 >> np.uint64(16))) & MASK
    h1 = (h1 * np.uint64(0x85EBCA6B)) & MASK
    h1 = (h1 ^ (h1 >> np.uint64(13))) & MASK
    h1 = (h1 * np.uint64(0xC2B2AE35)) & MASK
    h1 = (h1 ^ (h1 >> np.uint64(16))) & MASK
    out = h1.astype(np.int64)
    return np.where(out >= 2**31, out - 2**32, out)
