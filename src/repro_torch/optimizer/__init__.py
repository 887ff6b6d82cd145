"""Cost-based plan optimizer over the logical IR (DESIGN.md §11).

``optimize(plan)`` runs a pipeline of rewrite passes — each a pure
``Plan -> Plan`` function with recorded provenance — over the logical
trees that :func:`repro_torch.core.planner.plan` lowered from inspectable
declarative nodes:

- ``filter_pushdown``: filters move below joins onto the side they
  provably read; filters shared by several steps materialize once as
  an unpublished auxiliary step;
- ``join_reorder``: all-inner left-deep chains execute smallest-
  estimated side first (planner ``TableStats`` cardinalities), with
  the authored row order restored bit-for-bit;
- ``column_pruning``: dead source columns are elided, but only when no
  contract verifier and no downstream step references them
  (Appendix-A soundness via ``contracts.referenced_columns``);
- ``probe_fusion``: a filter feeding a join collapses into the join's
  masked probe (``Backend.masked_hash_join`` /
  ``kernels.hash_join.masked_hash_probe``), so filtered rows never
  materialize — on the card the mask is applied inside the probe
  kernel;
- ``partial_agg``: large single-int-key aggregations route to the
  partitioned backend's pre-exchange partial aggregation once it spans
  several cards (a no-op on one card)
  (``Aggregate.strategy="partial"``) — physical routing, with the
  strategy rendered in the tree description so cache keys move.

Every pass must preserve published tables bit for bit (``partial_agg``
within the documented float-SUM/MEAN summation-order carve-out); the
proof obligation is the differential suite
(``tests/test_optimizer_differential.py``). Pass membership and
per-step provenance are folded into engine cache keys, so toggling a
pass can never serve a stale cached result.
"""
from repro_torch.optimizer.passes import (DEFAULT_PASSES, PASSES,
                                    column_pruning, filter_pushdown,
                                    join_reorder, optimize,
                                    partial_agg, probe_fusion)

__all__ = ["DEFAULT_PASSES", "PASSES", "optimize", "filter_pushdown",
           "join_reorder", "column_pruning", "probe_fusion",
           "partial_agg"]
