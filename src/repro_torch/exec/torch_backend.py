"""Torch execution backend: group-by aggregation on the card.

The twin of ``repro.exec.jax_backend``. Inherits the vectorized
backend's join/filter/concat and key factorization (host-side, numpy)
and overrides only the aggregation inner loops: per-group SUM/MEAN run
through :func:`repro_torch.kernels.segment_sum.ops.masked_segment_sum`
and MIN/MAX through :func:`~repro_torch.kernels.segment_sum.ops.
masked_segment_reduce` — the CUDA kernels for ``device="cuda"`` (the
default), their plain PyTorch versions for ``device="cpu"``.

Exactness contract with the ``reference`` oracle:

- integer dtypes and MIN/MAX are bit-exact, including the sign of a
  tied ``±0.0`` (the later row's zero, as ``np.minimum`` gives);
- float sums are exact up to summation order (the documented
  carve-out), and bitwise the same on every run of one device;
- int64 and float64 stay on the device: torch has native 64-bit types,
  so there is no x64 flag to fall back on. Object, datetime, bool,
  bfloat16 and wide unsigned columns take the vectorized host path —
  the same semantic routing the JAX backend does, not a fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.exec import BackendUnavailable
from repro_torch.exec.base import fill_value
from repro_torch.exec.vectorized import VectorizedBackend
from repro_torch.kernels.device import device_supports_dtype
from repro_torch.kernels.segment_sum.ops import (masked_segment_reduce,
                                                 masked_segment_sum)

__all__ = ["TorchBackend", "resolve_device"]


def resolve_device(device: "str | torch.device",
                   backend: VectorizedBackend) -> torch.device:
    """``device`` checked for ``backend`` (named in the errors), with a
    CUDA card given no index resolved to the current one."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            cls = type(backend).__name__
            raise BackendUnavailable(
                f"execution backend {backend.name!r} runs on CUDA, and no "
                f"CUDA device is available; to run it on the CPU, ask "
                f"for it: use_backend({cls}(device=\"cpu\")), or "
                f"select the 'vectorized' backend")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"{type(backend).__name__} runs on cuda or cpu, "
                         f"not {device}")
    return device


class TorchBackend(VectorizedBackend):
    name = "torch"

    def __init__(self, *, device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device, self)

    def cache_token(self) -> str:
        # the device regroups float SUMs (the documented carve-out), so a
        # cache hit must not cross devices.
        return f"{self.name}[{self.device}]"

    @staticmethod
    def _segment_ids(order: np.ndarray, bounds: np.ndarray,
                     grp_order: np.ndarray, n_groups: int,
                     n: int) -> np.ndarray:
        """Per-row segment ids in output (first-appearance) order, from
        the group-run structure the vectorized base already computed."""
        run_lengths = np.diff(np.r_[bounds, n])
        inv_code = np.empty(n, dtype=np.int64)
        inv_code[order] = np.repeat(np.arange(n_groups), run_lengths)
        rank = np.empty(n_groups, dtype=np.int64)
        rank[grp_order] = np.arange(n_groups)
        return rank[inv_code]

    def _put(self, arr: np.ndarray,
             device: "torch.device | None" = None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device if device is None else device)

    def _device_args(self, values, ok, order, bounds, grp_order, n_groups):
        gid = self._segment_ids(order, bounds, grp_order, n_groups,
                                len(values))
        return (self._put(values), self._put(gid.astype(np.int32)),
                self._put(ok), n_groups)

    def _aggregate(self, values: np.ndarray, ok: np.ndarray,
                   order: np.ndarray, bounds: np.ndarray,
                   grp_order: np.ndarray, n_groups: int
                   ) -> tuple[np.ndarray, np.ndarray]:
        if n_groups == 0 or not device_supports_dtype(values.dtype):
            return super()._aggregate(values, ok, order, bounds,
                                      grp_order, n_groups)
        sums, counts = masked_segment_sum(*self._device_args(
            values, ok, order, bounds, grp_order, n_groups))
        # empty segments already hold 0 == the canonical numeric fill
        return sums.cpu().numpy(), counts.cpu().numpy() > 0

    def _agg_minmax(self, fn: str, values: np.ndarray, ok: np.ndarray,
                    order: np.ndarray, bounds: np.ndarray,
                    grp_order: np.ndarray, n_groups: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        vdt = values.dtype
        if n_groups == 0 or not device_supports_dtype(vdt):
            return super()._agg_minmax(fn, values, ok, order, bounds,
                                       grp_order, n_groups)
        red, counts = masked_segment_reduce(*self._device_args(
            values, ok, order, bounds, grp_order, n_groups), op=fn)
        # empty segments hold the reduce identity (±inf / dtype
        # extremes), not the canonical fill — rewrite them.
        red = red.cpu().numpy()
        has = counts.cpu().numpy() > 0
        red[~has] = fill_value(vdt)
        return red, has
