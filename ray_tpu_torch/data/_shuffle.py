"""Derived-permutation shuffle kernels for Arrow blocks.

The exchange's per-row work (reference: ray's push-based shuffle map
and reduce stages, python/ray/data/_internal/execution/) runs here as
seeded PRP gathers: a 4-round cycle-walking Feistel bijection on
[0, n) replaces materialized `Generator.permutation` arrays, and the
C++ kernel (ray_tpu_torch/_native/exchange.cc) fuses sigma(t) into the
gather loop, removing the index-array pass. Everything falls back to
vectorized numpy + Arrow `take` when the native library or zero-copy
column access is unavailable (nulls, strings, exotic dtypes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _keys(seed: int, n: int) -> "np.ndarray":
    return np.random.SeedSequence(
        [seed & 0x7FFFFFFF, n]).generate_state(4).astype(np.uint32)


def prp_indices(lo: int, hi: int, n: int, seed: int) -> "np.ndarray":
    """sigma([lo, hi)) for a seeded pseudo-random bijection of [0, n).

    Any slice of the permutation is computed independently — mappers
    and reducers derive exactly the rows they need with no shared
    state and nothing materialized at full length."""
    if hi <= lo:
        return np.empty(0, dtype=np.int64)
    keys = _keys(seed, n)
    lib = _lib()
    if lib is not None:
        out = np.empty(hi - lo, dtype=np.int64)
        lib.prp_indices(out.ctypes.data, lo, hi, n, keys.ctypes.data)
        return out
    return _prp_indices_numpy(lo, hi, n, keys)


def _prp_indices_numpy(lo: int, hi: int, n: int,
                       keys: "np.ndarray") -> "np.ndarray":
    """Vectorized fallback: same network, uint32 in-place rounds."""
    if n > (1 << 32):
        # the uint32 rounds below would wrap and stop being a bijection
        # (silent duplicated/dropped rows); the C++ path runs 64-bit
        # state and handles this size
        raise ValueError(
            f"numpy PRP fallback supports domains up to 2^32 rows, got "
            f"{n}; the native exchange library (ray_tpu_torch._native) is "
            "required for larger single-permutation domains")
    k = max((max(n, 2) - 1).bit_length(), 4)
    k += k & 1
    half = np.uint32(k // 2)
    mask = np.uint32((1 << (k // 2)) - 1)
    K = np.uint32(0x9E3779B1)
    sh = np.uint32(max(k // 2 - 3, 1))
    rs = keys.astype(np.uint32)

    def enc(v):
        L = v >> half
        R = v.copy()
        R &= mask
        F = np.empty_like(v)
        for r in range(4):
            np.multiply(R, K, out=F)
            F += rs[r]
            F >>= sh
            F &= mask
            L ^= F
            L, R = R, L
        L <<= half
        L |= R
        return L

    x = enc(np.arange(lo, hi, dtype=np.uint32))
    bad = x >= n
    while bad.any():
        x[bad] = enc(x[bad])
        bad = x >= n
    return x.astype(np.int64)


def _lib():
    from ray_tpu_torch import _native

    return _native.load_exchange_lib()


def _np_chunks(column) -> Optional[list]:
    """Zero-copy numpy views of a ChunkedArray's chunks, or None when
    the native gather can't apply (nulls, non-numeric, mixed dtype)."""
    out = []
    dtype = None
    for ch in column.chunks:
        if ch.null_count:
            return None
        try:
            arr = ch.to_numpy(zero_copy_only=True)
        except Exception:
            return None
        if arr.dtype.kind not in "iuf" or not arr.flags.c_contiguous:
            return None
        if dtype is None:
            dtype = arr.dtype
        elif arr.dtype != dtype:
            return None
        out.append(arr)
    return out or None


def prp_take_table(table, lo: int, hi: int, n: int, seed: int):
    """Rows sigma([lo, hi)) of an Arrow table (chunked or not), in
    permuted order. Numeric null-free columns gather in C++ with
    sigma(t) fused into the loop (no index-array pass); chunked
    columns compact into one contiguous buffer first — a sequential
    copy that keeps the gather cache-local, ~5x faster than hopping
    between scattered stripe chunks. Other columns fall back to Arrow
    take with shared PRP indices."""
    import pyarrow as pa

    m = hi - lo
    keys = _keys(seed, n)
    lib = _lib()
    idx = None  # computed lazily, once, for non-native columns
    cols, names = [], table.column_names
    for name in names:
        column = table.column(name)
        nps = _np_chunks(column) if lib is not None else None
        if nps is not None:
            dtype = nps[0].dtype
            out = np.empty(m, dtype=dtype)
            if len(nps) == 1:
                src = nps[0]
            else:
                # compact first: chunks are stripes scattered across
                # many distant blocks, and a gather hopping between
                # them pays a TLB/cache miss per row (~5x slower than
                # the sequential copy + one cache-local gather)
                src = np.concatenate(nps)
            lib.prp_gather(src.ctypes.data, out.ctypes.data,
                           dtype.itemsize, lo, hi, n, keys.ctypes.data)
            cols.append(pa.array(out))
        else:
            if idx is None:
                if lib is not None:
                    idx = np.empty(m, dtype=np.int64)
                    lib.prp_indices(idx.ctypes.data, lo, hi, n,
                                    keys.ctypes.data)
                else:
                    idx = _prp_indices_numpy(lo, hi, n, keys)
            cols.append(column.take(idx))
    return pa.table(cols, names=names)
