"""bfloat16 table columns without ``ml_dtypes``.

``repro`` holds a bfloat16 column as an ``ml_dtypes.bfloat16`` numpy
array; numpy has no such type of its own, and the port must not import
``ml_dtypes``. Here a bfloat16 column is a numpy array of the raw bits
under a one-field structured dtype, :data:`BFLOAT16`
(``[("bfloat16", "<u2")]``): two bytes a value, the same bytes
``ml_dtypes`` holds, so fingerprints and blobs stay byte-compatible.

numpy moves such an array (indexing, ``take``, ``concatenate``, fills)
like any other and refuses arithmetic on it, so nothing computes on the
bits by accident: every computation goes through this module, which
does what ``ml_dtypes`` does per operation. Widening to float32 is
exact (``bits << 16``); a result of bfloat16 type is computed in
float32 and rounded back to nearest-even in integer code, NaN to the
quiet NaN of its sign (``0x7fc0`` / ``0xffc0``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["BFLOAT16", "is_bfloat16", "dtype_name", "from_bits", "bits",
           "widen", "from_float32", "apply_ufunc", "astype", "tolist",
           "fold_runs", "add", "minimum", "maximum", "group_fold", "mean"]

BFLOAT16 = np.dtype([("bfloat16", "<u2")])


def is_bfloat16(dtype) -> bool:
    return dtype == BFLOAT16


def dtype_name(dtype: np.dtype) -> str:
    """The dtype's name as ``repro`` writes it (``"bfloat16"`` here)."""
    return "bfloat16" if is_bfloat16(dtype) else str(dtype)


def from_bits(raw: np.ndarray) -> np.ndarray:
    """A bfloat16 column over ``uint16`` bits (a view, no copy)."""
    return np.ascontiguousarray(raw, dtype=np.uint16).view(BFLOAT16)


def bits(arr: np.ndarray) -> np.ndarray:
    return arr.view(np.uint16)


def widen(arr: np.ndarray) -> np.ndarray:
    """float32 values of a bfloat16 column (exact)."""
    return (bits(arr).astype(np.uint32) << 16).view(np.float32)


def _round_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, round to nearest even."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    out = ((u + (0x7FFF + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    out[nan] = ((u[nan] >> 16) & 0x8000) | 0x7FC0
    return out


def from_float32(x) -> np.ndarray:
    """A bfloat16 column rounded from float32 values."""
    return _round_bits(np.asarray(x, dtype=np.float32)).view(BFLOAT16)


# ml_dtypes' promotion of bfloat16 with each numpy kind: the type the
# other operand and the bfloat16 are computed in, and whether the
# result is rounded back to bfloat16. Pairs it has no loop for raise.
_SAME = {np.dtype(t) for t in (np.bool_, np.int8, np.uint8)}
_F32 = {np.dtype(t) for t in (np.int16, np.uint16, np.float16,
                              np.float32)}
_F64 = {np.dtype(t) for t in (np.int32, np.uint32, np.int64, np.uint64,
                              np.float64)}


def _compute_type(other: np.dtype) -> tuple[type, bool]:
    if is_bfloat16(other) or other in _SAME:
        return np.float32, True
    if other in _F32:
        return np.float32, False
    if other in _F64:
        return np.float64, False
    raise TypeError(f"bfloat16 and {other} have no common type")


def apply_ufunc(op: np.ufunc, *args: np.ndarray) -> np.ndarray:
    """``op(*args)`` where an operand may be bfloat16, as ``ml_dtypes``
    computes it: bfloat16 with bool, int8, uint8 or bfloat16 in float32
    rounded back to bfloat16 (comparisons and logic give bool); with
    16-bit types and float32 in float32; with wider types in float64."""
    if not any(is_bfloat16(a.dtype) for a in args):
        return op(*args)
    others = [a.dtype for a in args if not is_bfloat16(a.dtype)]
    ctype, rounds = _compute_type(others[0] if others else BFLOAT16)
    wide = [widen(a).astype(ctype, copy=False) if is_bfloat16(a.dtype)
            else a.astype(ctype) for a in args]
    out = op(*wide)
    if rounds and out.dtype.kind == "f":
        return from_float32(out)
    return out


def astype(arr: np.ndarray, dtype) -> np.ndarray:
    """A cast out of bfloat16 goes through float32, as in ``ml_dtypes``."""
    if not is_bfloat16(arr.dtype):
        return arr.astype(dtype)
    if is_bfloat16(np.dtype(dtype)):
        return arr.copy()
    with np.errstate(invalid="ignore"):
        return widen(arr).astype(dtype)


def tolist(arr: np.ndarray) -> list:
    """Python floats, as ``ml_dtypes``' ``tolist`` gives them."""
    return widen(arr).tolist()


# -- element-wise ops on bits, each what ml_dtypes' ufunc does ----------

def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return _round_bits(widen(a) + widen(b))


def minimum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a`` where it is NaN or less than ``b``, else ``b``: of tied
    values (``±0.0``) the second operand wins."""
    fa, fb = widen(a), widen(b)
    return bits(np.where(np.isnan(fa) | (fa < fb), a, b))


def maximum(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    fa, fb = widen(a), widen(b)
    return bits(np.where(np.isnan(fa) | (fa > fb), a, b))


def fold_runs(op, values: np.ndarray, starts: np.ndarray,
              lengths: np.ndarray) -> np.ndarray:
    """Left fold of ``op`` over each run ``values[s : s + n]`` (every
    ``n`` at least 1), element by element in run order: the order a
    row loop, or numpy's ``reduceat`` over ``ml_dtypes``' loops, takes.
    One vector step per position, over the runs that reach it."""
    by_len = np.argsort(-lengths, kind="stable")
    s, n = starts[by_len], lengths[by_len]
    acc = bits(values[s]).copy()
    for pos in range(1, int(n[0]) if len(n) else 0):
        live = int(np.searchsorted(-n, -pos, side="left"))
        acc[:live] = op(acc[:live].view(BFLOAT16),
                        values[s[:live] + pos])
    out = np.empty(len(starts), dtype=np.uint16)
    out[by_len] = acc
    return out.view(BFLOAT16)


_GROUP_OPS = {"sum": add, "mean": add, "min": minimum, "max": maximum}


def group_fold(fn: str, values: np.ndarray, ok: np.ndarray,
               gid: np.ndarray, n_groups: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """Per group ``gid``, the left fold of ``fn``'s bfloat16 op over the
    group's rows where ``ok``, in row order: ``(result, count)``. SUM
    rounds to bfloat16 at each step, as a row loop over ``ml_dtypes``
    scalars does. A group without rows holds +0.0, the canonical fill."""
    rows = np.flatnonzero(ok)
    rows = rows[np.argsort(gid[rows], kind="stable")]
    counts = np.bincount(gid[rows], minlength=n_groups)
    has = counts > 0
    out = np.zeros(n_groups, dtype=BFLOAT16)
    out[has] = fold_runs(_GROUP_OPS[fn], values[rows],
                         (np.cumsum(counts) - counts)[has], counts[has])
    return out, counts


def mean(sums: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """MEAN finalized in float64 from bfloat16 sums; 0.0 where empty."""
    out = widen(sums).astype(np.float64)
    np.divide(out, counts, out=out, where=counts > 0)
    out[counts == 0] = 0.0
    return out
