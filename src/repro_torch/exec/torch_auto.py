"""Statistics-driven backend selection on one card (the ``torch_auto``
policy), the port's default backend.

The twin of ``repro.exec.auto``. ``torch_auto`` executes no operator
itself: each call takes (or collects) :mod:`~repro_torch.exec.stats` for
its inputs and delegates to the backend the decision table picks. Its
delegates are built on its own device, so ``TorchAutoBackend(
device="cpu")`` runs every row on the CPU and never touches CUDA.

====================  =========================================  ===========
operation             condition (first match wins)               backend
====================  =========================================  ===========
group_by_agg          a bfloat16 value column                    vectorized
join / group_by_agg   total rows <= tiny (64)                    reference
join                  total rows >= shard rows (200,000)         partitioned
join                  anything else                              vectorized
group_by_agg          rows >= shard rows, ``partitioned`` spans  partitioned
                      more than one card, a single int key with
                      a dense span, every value dtype lowers
group_by_agg          rows >= device rows (100,000) and every    torch
                      value dtype lowers (``kernels/device.py``)
group_by_agg          anything else                              vectorized
====================  =========================================  ===========

A bfloat16 value column is aggregated on the host, whatever its size:
the segment kernels take no bfloat16, and ``ml_dtypes`` rounds a sum
to bfloat16 at every step, which the host backends reproduce bit for
bit. The rule reads dtypes only, so it is decided before any launch.

Tiny tables are dominated by per-call constants, where the reference's
plain dicts beat any array setup; large joins go to the hash-probe
kernels on the card, large aggregations to the segment kernels.

The reference's "single int key with a dense span -> vectorized" join
row is left out here. On the host that row sends dense keys to the
vectorized backend's direct-address ``bincount`` probe, which no device
round trip amortizes on a TPU host; on the card the ``hash_probe``
kernel *is* that direct-address table, so large dense-key joins go to
``partitioned`` too. ``chip_smoke.py`` times the ``vectorized`` run of
the same queries beside it, so the choice can be measured. The
reference's sharded group-by row is here as the ``partitioned`` row:
per-partition partials pay only when several cards share the work, so
on one card it stays off, as ``repro``'s does on one device. The row
counts the cards of this backend's own ``partitioned`` delegate, the
instance it dispatches to; the ``partial_agg`` pass counts those of the
registered ``partitioned``, the instance a rewritten aggregate runs on,
and the cache key carries that instance's token (``engine.cache_key``).

The thresholds keep the reference's values and are machine constants,
not semantics: every candidate agrees with ``reference`` bit for bit
(float SUM/MEAN within the summation-order carve-out), so a wrong pick
costs time, never correctness. The engine folds :meth:`TorchAutoBackend.cache_token` —
policy version, thresholds, device and the delegates' own tokens — into
node cache keys.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.data import bfloat16
from repro_torch.exec import BackendUnavailable
from repro_torch.exec.base import (AggSpec, Backend, Columns,
                                   normalize_agg_specs)
from repro_torch.exec.stats import TableStats, collect_stats
from repro_torch.exec.vectorized import dense_span_affordable
from repro_torch.kernels.device import device_supports_dtype
from repro_torch.obs import get_recorder

__all__ = ["TorchAutoBackend", "choose_join", "choose_group_by_agg",
           "explain_join", "explain_group_by_agg"]

# v2: the group-by table learned the partitioned partial-aggregation
# row; the bump moves every cache key of the earlier policy.
_POLICY_VERSION = 2

TINY_ROWS = 64
SHARD_ROWS = 200_000
DEVICE_ROWS = 100_000


def explain_join(left: TableStats, right: TableStats) -> tuple[str, str]:
    """The join decision table, returning ``(backend, why)``: the reason
    names the row that fired and rides into run manifests as the
    ``auto_decision`` event's ``reason``."""
    total = left.n_rows + right.n_rows
    if total <= TINY_ROWS:
        return "reference", (
            f"total rows {total} <= tiny threshold {TINY_ROWS}")
    if total >= SHARD_ROWS:
        return "partitioned", (
            f"total rows {total} >= shard threshold {SHARD_ROWS} "
            f"(hash probe kernels on the card)")
    return "vectorized", "default row (no specialized row matched)"


def choose_join(left: TableStats, right: TableStats) -> str:
    """The stats -> backend decision table for joins."""
    return explain_join(left, right)[0]


def explain_group_by_agg(stats: TableStats,
                         value_dtypes: Sequence[np.dtype], *,
                         cards: int = 1) -> tuple[str, str]:
    """The group_by_agg decision table, returning ``(backend, why)``;
    ``cards`` is the number of cards ``partitioned`` spans."""
    if any(bfloat16.is_bfloat16(dt) for dt in value_dtypes):
        return "vectorized", (
            "bfloat16 value column: aggregated on the host, rounded as "
            "ml_dtypes rounds (no device bfloat16 aggregation)")
    if stats.n_rows <= TINY_ROWS:
        return "reference", (
            f"rows {stats.n_rows} <= tiny threshold {TINY_ROWS}")
    lowers = all(device_supports_dtype(dt) for dt in value_dtypes)
    if (stats.n_rows >= SHARD_ROWS and cards > 1 and lowers
            and stats.single_int_key and _dense_group_span(stats)):
        return "partitioned", (
            f"rows {stats.n_rows} >= shard threshold {SHARD_ROWS} on "
            f"{cards} cards with dense single int key and "
            f"device-lowerable values (per-partition partials)")
    if stats.n_rows >= DEVICE_ROWS and lowers:
        return "torch", (
            f"rows {stats.n_rows} >= device threshold {DEVICE_ROWS} "
            f"with device-lowerable values (segment-reduce kernels)")
    if not lowers:
        return "vectorized", "value dtype(s) not device-lowerable"
    return "vectorized", "default row (no specialized row matched)"


def choose_group_by_agg(stats: TableStats,
                        value_dtypes: Sequence[np.dtype], *,
                        cards: int = 1) -> str:
    """The stats -> backend decision table for group_by_agg."""
    return explain_group_by_agg(stats, value_dtypes, cards=cards)[0]


def _dense_group_span(stats: TableStats) -> bool:
    if None in (stats.int_key_lo, stats.int_key_hi):
        return False
    span = stats.int_key_hi - stats.int_key_lo + 1
    return dense_span_affordable(span, stats.n_rows)


class TorchAutoBackend(Backend):
    name = "torch_auto"

    def __init__(self, *, device: "str | torch.device" = "cuda"):
        from repro_torch.exec.partitioned import PartitionedBackend
        from repro_torch.exec.reference import ReferenceBackend
        from repro_torch.exec.torch_backend import TorchBackend
        from repro_torch.exec.vectorized import VectorizedBackend
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            raise BackendUnavailable(
                "execution backend 'torch_auto' runs on CUDA, and no CUDA "
                "device is available; to run it on the CPU, ask for it: "
                "use_backend(TorchAutoBackend(device=\"cpu\")), or select "
                "the 'vectorized' backend")
        on_device = TorchBackend(device=device)
        self.device = on_device.device
        self._delegates: dict[str, Backend] = {
            "reference": ReferenceBackend(),
            "vectorized": VectorizedBackend(),
            "torch": on_device,
            # "cuda" with no index: every visible card
            "partitioned": PartitionedBackend(device=device),
        }

    def delegate(self, name: str) -> Backend:
        """The delegate that a decision-table row names."""
        return self._delegates[name]

    def cache_token(self) -> str:
        # the device delegates' tokens carry the device and layout, which
        # regroup float SUMs: a change there must move this key too.
        delegated = ",".join(self._delegates[n].cache_token()
                             for n in ("torch", "partitioned"))
        return (f"{self.name}[v{_POLICY_VERSION};tiny={TINY_ROWS};"
                f"shard={SHARD_ROWS};device_rows={DEVICE_ROWS};"
                f"{delegated}]")

    # -- operators -------------------------------------------------------
    # The engine threads planner-collected TableStats through dispatch
    # (PlanStep.input_stats); inputs without stats (intermediates the
    # planner never saw, direct Table-API calls) are measured here once,
    # against the physical input of this call.
    accepts_join_stats = True

    def _join_choice(self, left: Columns, right: Columns,
                     on: Sequence[str],
                     left_stats: "TableStats | None",
                     right_stats: "TableStats | None",
                     op: str = "hash_join") -> str:
        if left_stats is None:
            left_stats = collect_stats(left, on,
                                       estimate_cardinality=False)
        if right_stats is None:
            right_stats = collect_stats(right, on,
                                        estimate_cardinality=False)
        choice, reason = explain_join(left_stats, right_stats)
        rec = get_recorder()
        if rec.enabled:
            rec.event("auto_decision", op=op, choice=choice,
                      reason=reason, left_rows=left_stats.n_rows,
                      right_rows=right_stats.n_rows,
                      device=str(self.device))
            rec.metrics.counter(f"auto.{op}.{choice}").inc()
        return choice

    def hash_join(self, left: Columns, right: Columns,
                  on: Sequence[str], how: str = "inner", *,
                  left_stats: "TableStats | None" = None,
                  right_stats: "TableStats | None" = None) -> Columns:
        choice = self._join_choice(left, right, on, left_stats,
                                   right_stats)
        return self.delegate(choice).hash_join(left, right, on, how)

    def masked_hash_join(self, left: Columns, right: Columns,
                         on: Sequence[str], how: str = "inner", *,
                         left_mask: "np.ndarray | None" = None,
                         right_mask: "np.ndarray | None" = None,
                         left_stats: "TableStats | None" = None,
                         right_stats: "TableStats | None" = None
                         ) -> Columns:
        # stats describe the unfiltered inputs: the tables the fused
        # probe actually touches.
        choice = self._join_choice(left, right, on, left_stats,
                                   right_stats, op="masked_hash_join")
        return self.delegate(choice).masked_hash_join(
            left, right, on, how,
            left_mask=left_mask, right_mask=right_mask)

    accepts_group_stats = True

    def group_by_agg(self, cols: Columns, keys: Sequence[str],
                     specs: Sequence[AggSpec], *,
                     stats: "TableStats | None" = None) -> Columns:
        specs = normalize_agg_specs(cols, keys, specs)
        if stats is None:
            stats = collect_stats(cols, keys,
                                  estimate_cardinality=False)
        choice, reason = explain_group_by_agg(
            stats, tuple(cols[value][0].dtype for _fn, value, _o in specs),
            cards=self._delegates["partitioned"].cards)
        rec = get_recorder()
        if rec.enabled:
            rec.event("auto_decision", op="group_by_agg",
                      choice=choice, reason=reason, rows=stats.n_rows,
                      device=str(self.device))
            rec.metrics.counter(f"auto.group_by_agg.{choice}").inc()
        return self.delegate(choice).group_by_agg(cols, keys, specs)

    def group_by_sum(self, cols: Columns, keys: Sequence[str],
                     value: str, out: str, *,
                     stats: "TableStats | None" = None) -> Columns:
        return self.group_by_agg(cols, keys, (("sum", value, out),),
                                 stats=stats)
