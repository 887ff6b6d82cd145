"""Partitioned hash join and partial group-by over a list of cards: the
twin of ``repro``'s ``sharded`` backend.

``repro.exec.sharded`` splits the join's key space over a JAX mesh, one
key range per device, and runs one ``shard_map`` call over every device
from one process. The port's counterpart of that mesh is one process
that owns a list of cards (``devices``, every visible CUDA card by
default) and moves data between them with peer copies; partition ``p``
lives on ``devices[p % cards]``, and results gather on the first card
before they go to the host. One card gives one partition, and the
layout is the identity (DESIGN.md §10).

The join:

1. **Key coding** (host, numpy). A single same-kind integer key ships
   as its raw values when they are already int32 slot codes, or rebased
   to ``key - min`` when the span fits int32. int64 keys whose span is
   wider stay int64 on the card ("hash" mode): torch has native 64-bit
   integers, so nothing degrades for lack of an x64 flag. Everything
   else (multi-column, object, cross-kind and bfloat16 keys, unsigned
   keys past the int64 range) goes through the joint factorization
   (``vectorized._join_codes``, bfloat16 in its float32 form) to dense
   int32 codes, which the probe kernels take as any other slot code.
   Unmatchable rows (NULL and NaN keys) are coded to the dtype's max,
   the sentinel.
2. **Partition** (host). ``partitions`` key ranges (a mixing hash in
   hash mode); each range gets the rows of every source chunk in row
   order, laid out owner-major, as the sharded backend's ``all_to_all``
   would deliver them. So each owner's build and probe lanes go
   straight to its own card.
3. **Probe** (each partition on its card). "Table" mode (key span up
   to ``MAX_TABLE_SPAN``) builds the direct-address ``(start, count)``
   table over the partition's slot range with integer ``bincount`` and
   scatters, and probes it through the CUDA ``hash_probe`` kernel, or
   ``masked_hash_probe`` with the probe-side filter fused in. "Hash"
   mode (wider spans) sorts the build keys and binary-searches them
   (``torch.sort``/``torch.searchsorted``), as the reference does in
   XLA. Every sort that must keep row order within a key is stable.
4. **Ragged emission** (host). Per-partition ``(start, count)`` pairs
   map back to left row order through the kept layout and expand
   through the vectorized backend's ``_emit_join``: the output equals
   ``reference``'s bit for bit, row order included, on any list of
   cards.

The group-by (``_partial_group_by``, ``sharded.py``'s partial
aggregation): a single integer key with a dense span is rebased on the
host to slot codes in O(n), with one more slot for NULL keys. Each
source partition, a contiguous range of rows, reduces its rows into
every slot on its own card through the segment kernels
(``masked_segment_sum`` for COUNT and SUM, ``masked_segment_reduce``
for MIN and MAX). Owner ``d`` receives slot range ``d`` of every
source's partials by peer copy and combines them in source order
through the same kernels, so integers wrap in the value dtype, float
sums take no atomics, a NaN in any partition poisons its slot and of
tied MIN/MAX values the later partition's wins, as the later row does
in ``reference``. MEAN is SUM / COUNT on the host. The output order
(first appearance) comes from the slot codes on the host, never from
the card. Everything else (other keys, bfloat16 or host-only values,
wide spans) takes the inherited :class:`TorchBackend` path.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.exec.base import (AggSpec, Columns, _column_length,
                                   fill_value, normalize_agg_specs,
                                   payload_validity)
from repro_torch.exec.torch_backend import TorchBackend, resolve_device
from repro_torch.exec.vectorized import (VectorizedBackend, _and_key_validity,
                                         _join_codes, dense_span_affordable)
from repro_torch.kernels.device import device_supports_dtype
from repro_torch.kernels.hash_join.ops import hash_probe, masked_hash_probe
from repro_torch.kernels.segment_sum.ops import (masked_segment_reduce,
                                                 masked_segment_sum)
from repro_torch.obs import get_recorder

__all__ = ["PartitionedBackend", "MAX_TABLE_SPAN"]

# Key spans up to this use contiguous-range partitions with a
# power-of-two slot space per partition ("table" mode: the probe
# kernels' direct-address path; the partition of a key is a shift, and
# the int32 sentinel lands past the last partition). Wider key spaces
# hash-partition ("hash" mode).
MAX_TABLE_SPAN = 1 << 26

_NOOP_CTX = contextlib.nullcontext()
_INT32_SENT = np.int32(np.iinfo(np.int32).max)


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _round_cap(n: int) -> int:
    """Partition capacity rounding: up to the next multiple of the
    value's third-highest bit (at most 12.5% padding), so the set of
    distinct shapes stays small."""
    n = max(int(n), 64)
    gran = max(64, 1 << (n.bit_length() - 3))
    return -(-n // gran) * gran


def _mix32(h: np.ndarray) -> np.ndarray:
    """Deterministic int32 mixing hash (wraparound multiply)."""
    h = h ^ (h >> np.int32(16))
    with np.errstate(over="ignore"):
        h = (h * np.int32(0x45D9F3B)).astype(np.int32)
    h = h ^ (h >> np.int32(13))
    return h & np.int32(0x7FFFFFFF)


def _sentinel(dtype: np.dtype):
    return dtype.type(np.iinfo(dtype).max)


class PartitionedBackend(TorchBackend):
    name = "partitioned"

    def __init__(self, *, device: "str | torch.device" = "cuda",
                 devices: "Sequence[str | torch.device] | None" = None,
                 partitions: "int | None" = None):
        """``devices``: the cards, first the one results gather on; by
        default every visible card when ``device`` is ``"cuda"`` with no
        index, else ``[device]``; a given list replaces ``device``.
        ``partitions``: the key ranges of the join and the row ranges of
        the group-by, partition ``p`` on ``devices[p % cards]``; by
        default one per card."""
        if devices is None:
            devices = [device]
            if torch.device(device) == torch.device("cuda"):
                # no index: every visible card, the current one first
                devices += [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())
                            if i != torch.cuda.current_device()]
        devices = [resolve_device(d, self) for d in devices]
        if not devices:
            raise ValueError("devices must name at least one card")
        self.device = devices[0]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"the cards must all be cuda or all cpu, not "
                             f"{[str(d) for d in devices]}")
        self.devices = tuple(devices)
        self.cards = len(self.devices)
        if partitions is None:
            partitions = self.cards
        if not 1 <= int(partitions) <= 255:     # partition ids are uint8
            raise ValueError(f"partitions must lie in [1, 255], not "
                             f"{partitions}")
        self.partitions = int(partitions)

    def _card(self, p: int) -> torch.device:
        """The card that partition ``p`` lives on."""
        return self.devices[p % self.cards]

    def cache_token(self) -> str:
        # the device regroups float SUMs, and so does the list of cards
        # (the partial group-by adds per partition); the partition count
        # is part of the physical layout (join output is exact under
        # every count, but a layout change must never be served a
        # cross-layout cache hit unnoticed).
        cards = ",".join(map(str, self.devices))
        return f"{self.name}[{cards};partitions={self.partitions}]"

    # -- join -----------------------------------------------------------
    def hash_join(self, left: Columns, right: Columns,
                  on: Sequence[str], how: str = "inner") -> Columns:
        return self._partitioned_join(left, right, on, how, None)

    def masked_hash_join(self, left: Columns, right: Columns,
                         on: Sequence[str], how: str = "inner", *,
                         left_mask: "np.ndarray | None" = None,
                         right_mask: "np.ndarray | None" = None
                         ) -> Columns:
        """Filter-fused join. The right mask folds into the key validity
        (masked build rows code to the sentinel and never match). The
        left (probe) mask goes to the card and is applied inside the
        ``masked_hash_probe`` kernel in table mode; every other route
        codes masked probe keys to the sentinel on the host. A left join
        with a left mask prefilters: a masked row must not emit as
        unmatched."""
        if left_mask is not None and how != "inner":
            left = self.filter_select(left, left_mask)
            left_mask = None
        if right_mask is not None:
            right = _and_key_validity(right, on, right_mask)
        return self._partitioned_join(left, right, on, how, left_mask)

    def _host_join(self, left: Columns, right: Columns,
                   on: Sequence[str], how: str,
                   probe_mask: "np.ndarray | None", *, reason: str
                   ) -> Columns:
        """The vectorized backend's join, for inputs the card path does
        not take; recorded as a degradation event when tracing is on."""
        rec = get_recorder()
        if rec.enabled:
            rec.event("degradation", kind="partitioned_downgrade",
                      op="hash_join", reason=reason)
            rec.metrics.counter("partitioned.downgrades").inc()
        if probe_mask is not None:              # inner joins only here
            left = _and_key_validity(left, on, probe_mask)
        return VectorizedBackend.hash_join(self, left, right, on, how)

    def _partitioned_join(self, left: Columns, right: Columns,
                          on: Sequence[str], how: str,
                          probe_mask: "np.ndarray | None") -> Columns:
        n_left = _column_length(left)
        n_right = _column_length(right)
        ndev = self.partitions
        if n_left == 0 or n_right == 0:
            return self._host_join(left, right, on, how, probe_mask,
                                   reason="empty input side")
        if n_left >= 2**31 or n_right >= 2**31:
            return self._host_join(left, right, on, how, probe_mask,
                                   reason="row count exceeds int32")
        keyed = self._device_keys(left, right, on)
        if keyed is None:
            return self._host_join(
                left, right, on, how, probe_mask,
                reason="joint key cardinality exceeds the int32 code "
                       "space")
        lk, rk, span = keyed
        if span == 0:                   # no valid key anywhere
            return self._emit_join(
                left, right, how, n_left,
                np.zeros(n_left, np.int64), np.zeros(n_left, np.int64),
                np.array([], dtype=np.int64))
        # power-of-two slot space per partition: the partition of a key
        # is a shift, and the sentinel lands past the last partition.
        span_shard = (_next_pow2(-(-span // ndev))
                      if 0 < span <= MAX_TABLE_SPAN else 0)

        # the fused mask rides to the kernel in table mode; every other
        # route codes masked lanes to the sentinel here.
        fused = probe_mask is not None and span_shard > 0
        if probe_mask is not None and not fused:
            lk = np.where(np.asarray(probe_mask, dtype=bool), lk,
                          _sentinel(lk.dtype))

        l_slab, l_idx, cap_l = _layout(lk, ndev, span_shard)
        r_slab, r_idx, cap_r = _layout(rk, ndev, span_shard)
        if ndev * cap_l >= 2**31 or ndev * cap_r >= 2**31:
            return self._host_join(
                left, right, on, how, probe_mask,
                reason="padded partition lanes exceed int32 positions "
                       "(partition skew)")
        # owner-major: partition d probes every source chunk's rows of
        # its key range, chunk after chunk (the arrival order an
        # all_to_all would give, which is global row order per key).
        l_own = l_slab.transpose(1, 0, 2).reshape(ndev, ndev * cap_l)
        r_own = r_slab.transpose(1, 0, 2).reshape(ndev, ndev * cap_r)
        arr_l = l_idx.transpose(1, 0, 2).reshape(ndev, ndev * cap_l)
        arr_r = r_idx.transpose(1, 0, 2).reshape(ndev, ndev * cap_r)
        m_own = None
        if fused:
            keep = np.asarray(probe_mask, dtype=bool)
            m_own = (keep.reshape(1, -1) if ndev == 1 else
                     np.where(arr_l >= 0, keep[np.clip(arr_l, 0, None)],
                              False))

        rec = get_recorder()
        kernel_ctx = _NOOP_CTX
        if rec.enabled:
            moved = l_own.nbytes + r_own.nbytes + (
                m_own.nbytes if fused else 0)
            kernel_ctx = rec.span(
                "kernel", op="partitioned.probe", partitions=ndev,
                mode=("table" if span_shard > 0 else "hash"),
                fused_mask=fused, h2d_bytes=moved,
                rows_left=n_left, rows_right=n_right)
        starts = np.empty(l_own.shape, np.int32)
        counts = np.empty(l_own.shape, np.int32)
        gidx = np.empty(r_own.shape, np.int32)
        with kernel_ctx:
            for d in range(ndev):
                starts[d], counts[d], gidx[d] = self._probe(
                    l_own[d], r_own[d], d * span_shard, span_shard,
                    None if m_own is None else m_own[d], self._card(d))

        # int64 from here: the emission cumsums counts, and a join of
        # more than 2**31 output rows must not wrap there.
        if ndev == 1:
            # the identity layout: arrival position is row id already
            return self._emit_join(left, right, how, n_left,
                                   starts[0].astype(np.int64),
                                   counts[0].astype(np.int64),
                                   gidx[0].astype(np.int64))
        # map back through the kept layout: the grouped build layout is
        # the partition's arrival order permuted by gidx, and arrival
        # order is the host's own layout, so the translation to global
        # row ids is one gather; padding cells (-1) are never read.
        # A key's run lies in one partition, so concatenating the
        # partitions' layouts (stride ndev*cap_r) is a grouped layout
        # for the shared ragged emission.
        stride = ndev * cap_r
        ridx = np.take_along_axis(
            arr_r, gidx.astype(np.int64, copy=False), axis=1).reshape(-1)
        starts_g = np.zeros(n_left, np.int64)
        counts_g = np.zeros(n_left, np.int64)
        m = arr_l >= 0
        starts_g[arr_l[m]] = (starts.astype(np.int64)
                              + (np.arange(ndev, dtype=np.int64)
                                 * stride)[:, None])[m]
        counts_g[arr_l[m]] = counts[m]
        return self._emit_join(left, right, how, n_left, starts_g,
                               counts_g, ridx.astype(np.int64, copy=False))

    # -- the probe on the device ------------------------------------------
    def _probe(self, lk: np.ndarray, rk: np.ndarray, base: int,
               span_shard: int, lmask: "np.ndarray | None",
               card: torch.device
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One partition: per probe lane ``(start, count)`` into the
        grouped build layout, and ``gidx`` (grouped position -> arrival
        position), computed on the partition's card."""
        sent = int(_sentinel(lk.dtype))
        lk_t, rk_t = self._put(lk, card), self._put(rk, card)
        if span_shard > 0:
            out = _probe_table(
                lk_t, rk_t, base, span_shard,
                None if lmask is None else self._put(lmask, card))
        elif lk.dtype.itemsize > 4:
            out = _probe_wide(lk_t, rk_t, sent)
        else:
            out = _probe_packed(lk_t, rk_t, sent)
        return tuple(t.cpu().numpy() for t in out)

    # -- key coding ------------------------------------------------------
    def _device_keys(self, left: Columns, right: Columns,
                     on: Sequence[str]):
        """``(lkeys, rkeys, span)`` with unmatchable rows coded to the
        dtype's max. span > 0: int32 slot codes in ``[0, span)``; span <
        0: raw int64 keys (hash mode); span == 0: no valid key at all.
        None when the joint cardinality does not fit int32 codes."""
        raw = self._raw_int_keys(left, right, on)
        if raw is not None:
            return raw
        lcodes, rcodes = _join_codes(left, right, on)
        card = int(max(lcodes.max(initial=-1),
                       rcodes.max(initial=-1))) + 1
        if card == 0:
            return lcodes.astype(np.int32), rcodes.astype(np.int32), 0
        if card >= 2**31 - 64:
            return None
        lk = lcodes.astype(np.int32)
        rk = rcodes.astype(np.int32)
        lk[lk < 0] = _INT32_SENT
        rk[rk < 0] = _INT32_SENT
        return lk, rk, card

    def _raw_int_keys(self, left: Columns, right: Columns,
                      on: Sequence[str]):
        """A single same-kind integer key ships as raw or rebased values
        (numpy equality is Python equality for integer kinds), with no
        factorization; None sends the key to the joint factorization."""
        if len(on) != 1:
            return None
        lv, lval = left[on[0]]
        rv, rval = right[on[0]]
        if (lv.dtype == object or rv.dtype == object
                or lv.dtype.kind not in "iu"
                or lv.dtype.kind != rv.dtype.kind):
            return None
        lok = payload_validity(lv, lval)
        rok = payload_validity(rv, rval)
        if not lok.any() or not rok.any():
            return None                   # the codes path: no valid key
        lvv = lv if lok.all() else lv[lok]
        rvv = rv if rok.all() else rv[rok]
        lo = min(int(lvv.min()), int(rvv.min()))
        hi = max(int(lvv.max()), int(rvv.max()))
        span = hi - lo + 1
        if (0 <= lo and hi < 2**31 - 64
                and (hi < MAX_TABLE_SPAN or span > MAX_TABLE_SPAN)):
            # the values already are int32 slot codes: no rebase. Not
            # taken when only the rebased span fits the table (dense
            # but offset keys): the shortcut must never cost table mode.
            lk = lv.astype(np.int32)
            rk = rv.astype(np.int32)
            lk[~lok] = _INT32_SENT
            rk[~rok] = _INT32_SENT
            return lk, rk, hi + 1
        if span <= 2**31 - 64:
            # rebase to slot codes. uint64 subtracts in its own dtype
            # (lo is the joint min, so nothing wraps); every other kind
            # widens to int64 first (a narrow dtype would wrap, and lo
            # need not fit it). The results lie in [0, span).
            def rebase(v):
                if v.dtype.kind == "u" and v.dtype.itemsize == 8:
                    return (v - v.dtype.type(lo)).astype(np.int32)
                return (v.astype(np.int64) - lo).astype(np.int32)

            lk = rebase(lv)
            rk = rebase(rv)
            lk[~lok] = _INT32_SENT
            rk[~rok] = _INT32_SENT
            return lk, rk, span
        if -2**63 <= lo and hi <= 2**63 - 2:
            # wide int64 keys stay int64 on the card (hash mode)
            sent = _sentinel(np.dtype(np.int64))
            lk = lv.astype(np.int64)
            rk = rv.astype(np.int64)
            lk[~lok] = sent
            rk[~rok] = sent
            return lk, rk, -1
        return None                       # uint64 past int64: codes path

    # -- aggregation -----------------------------------------------------
    def group_by_agg(self, cols: Columns, keys: Sequence[str],
                     specs: Sequence[AggSpec]) -> Columns:
        specs = normalize_agg_specs(cols, keys, specs)
        partial = self._partial_group_by(cols, keys, specs)
        if partial is not None:
            return partial
        return super().group_by_agg(cols, keys, specs)

    def _partial_group_by(self, cols: Columns, keys: Sequence[str],
                          specs: tuple[AggSpec, ...]) -> "Columns | None":
        """Per-partition partials, combined on their owner cards; None
        when ineligible (the inherited path takes over): one integer
        key whose span is dense enough to direct-address, every value
        column one the segment kernels take. NULL keys take one extra
        slot (SQL: one NULL group); integer keys cannot be NaN."""
        n = _column_length(cols)
        ndev = self.partitions
        if n == 0 or n >= 2**31 - 2 or len(keys) != 1:
            return None
        kv, kvalid = cols[keys[0]]
        if kv.dtype == object or kv.dtype.kind not in "iu":
            return None
        want: dict[str, set] = {}       # value column -> its partials
        for fn, value, _out in specs:
            if not device_supports_dtype(cols[value][0].dtype):
                return None             # bfloat16 and host-only dtypes
            stats = want.setdefault(value, set())
            if fn in ("sum", "mean"):
                stats.add("sum")
            elif fn in ("min", "max"):
                stats.add(fn)
        kok = payload_validity(kv, kvalid)
        any_null = not bool(kok.all())
        if kok.any():
            kvv = kv[kok] if any_null else kv
            lo = int(kvv.min())
            span = int(kvv.max()) - lo + 1
        else:
            lo, span = 0, 0
        if span > MAX_TABLE_SPAN or not dense_span_affordable(span, n):
            return None
        n_slots = span + (1 if any_null else 0)   # last slot = NULL group
        seg_shard = _next_pow2(-(-n_slots // ndev))
        nseg = ndev * seg_shard
        if nseg > MAX_TABLE_SPAN:
            return None

        # host: O(n) rebase to dense slot codes, no sort, no factorize
        if kv.dtype.kind == "u" and kv.dtype.itemsize == 8:
            gid = (kv - kv.dtype.type(lo)).astype(np.int32)
        else:
            gid = (kv.astype(np.int64, copy=False) - lo).astype(np.int32)
        if any_null:
            gid[~kok] = np.int32(span)
        chunk = -(-n // ndev)
        sources = [(s, s * chunk, min(n, (s + 1) * chunk))
                   for s in range(ndev) if s * chunk < n]
        names = list(want)
        oks = {name: payload_validity(*cols[name]) for name in names}

        rec = get_recorder()
        kernel_ctx = _NOOP_CTX
        if rec.enabled:
            # per column one int32 COUNT partial and one value-dtype
            # partial per stat, seg_shard lanes from each source to each
            # other owner; "peer" counts those between two cards of the
            # list (a card listed twice copies nothing on the device).
            lane = sum(4 + cols[name][0].dtype.itemsize * len(want[name])
                       for name in names)
            pairs = [(s, d) for s, _, _ in sources for d in range(ndev)
                     if s != d]
            moved = lane * seg_shard * len(pairs)
            peer = lane * seg_shard * sum(
                s % self.cards != d % self.cards for s, d in pairs)
            kernel_ctx = rec.span(
                "kernel", op="partitioned.partial_agg", cards=self.cards,
                partitions=ndev, rows=n, slots=n_slots,
                exchange_bytes=moved, peer_bytes=peer)
            rec.metrics.histogram(
                "partitioned.exchange_bytes").observe(moved)
        with kernel_ctx:
            # each source partition reduces its rows on its own card
            partials = []
            for s, a, b in sources:
                card = self._card(s)
                g = self._put(gid[a:b], card)
                partials.append({
                    name: _reduce(self._put(cols[name][0][a:b], card), g,
                                  self._put(oks[name][a:b], card),
                                  nseg=nseg, stats=want[name])
                    for name in names})
            # first appearance per slot, on the host while the cards
            # work: the reversed assignment leaves each slot its FIRST
            # row (later writes win)
            first = np.full(n_slots, n, dtype=np.int64)
            first[gid[::-1]] = np.arange(n - 1, -1, -1, dtype=np.int64)
            codes = np.flatnonzero(first < n)
            out_codes = codes[np.argsort(first[codes], kind="stable")]
            # owner d combines slot range d of every source, then the
            # first card gathers the output slots
            owners = [self._combine(partials, d, seg_shard)
                      for d in range(ndev)]
            at = self._put(out_codes)
            got = {name: {
                stat: _gather([o[name][stat] for o in owners], self.device,
                              at).cpu().numpy()
                for stat in partials[0][name]} for name in names}

        kdt = kv.dtype
        if kdt.kind == "u" and kdt.itemsize == 8:
            keyvals = kdt.type(lo) + out_codes.astype(kdt)
        else:
            keyvals = (out_codes + lo).astype(kdt)
        kmask = np.ones(len(out_codes), dtype=bool)
        if any_null:
            kmask = out_codes != span
            keyvals[~kmask] = fill_value(kdt)
        data: dict[str, tuple[np.ndarray, np.ndarray | None]] = {
            keys[0]: (keyvals, kmask)}
        for fname, value, out_name in specs:
            cnt = got[value]["count"].astype(np.int64)
            if fname == "count":
                data[out_name] = (cnt, None)
                continue
            has = cnt > 0
            if fname == "mean":
                m = got[value]["sum"].astype(np.float64)
                np.divide(m, cnt, out=m, where=has)
                m[~has] = fill_value(np.dtype(np.float64))
                data[out_name] = (m, has)
                continue
            vdt = cols[value][0].dtype
            r = got[value][fname].astype(vdt, copy=True)
            r[~has] = fill_value(vdt)
            data[out_name] = (r, has)
        return data

    def _combine(self, partials: list, d: int, seg_shard: int) -> dict:
        """Owner ``d``'s slot range: every source's partials for it,
        copied to the owner's card and combined there in source order
        through the segment kernels."""
        card = self._card(d)
        lo, hi = d * seg_shard, (d + 1) * seg_shard
        if len(partials) == 1:
            return {name: {stat: t[lo:hi] for stat, t in got.items()}
                    for name, got in partials[0].items()}
        ids = torch.arange(seg_shard, dtype=torch.int32,
                           device=card).repeat(len(partials))
        out = {}
        for name in partials[0]:
            part = {stat: torch.cat([p[name][stat][lo:hi].to(card)
                                     for p in partials])
                    for stat in partials[0][name]}
            # a source's empty slot holds 0 or the reduce identity:
            # left out of every combine
            has = part["count"] > 0
            got = {"count": masked_segment_sum(part["count"], ids, has,
                                               seg_shard)[0]}
            if "sum" in part:
                got["sum"] = masked_segment_sum(part["sum"], ids, has,
                                                seg_shard)[0]
            for op in ("min", "max"):
                if op in part:
                    got[op] = masked_segment_reduce(part[op], ids, has,
                                                    seg_shard, op=op)[0]
            out[name] = got
        return out

# ---------------------------------------------------------------------------
# probe strategies (torch, on the backend's device)
# ---------------------------------------------------------------------------

def _probe_table(lk: torch.Tensor, rk: torch.Tensor, base: int,
                 span_shard: int, lmask: "torch.Tensor | None"):
    """Direct-address strategy: build the ``(start, count)`` table over
    the partition's slot range and probe it through the hash-probe
    kernels. The grouped layout is arrival order when the build keys are
    unique, else the stable sort of the slots (ties keep arrival order,
    which is global row order)."""
    dev = rk.device
    m = rk.shape[0]
    iota = torch.arange(m, dtype=torch.int32, device=dev)
    slot_r = rk - base                  # the sentinel stays out of range
    slot_l = lk - base
    inr = (slot_r >= 0) & (slot_r < span_shard)
    counts_tab = torch.bincount(slot_r[inr].long(), minlength=span_shard
                                ).to(torch.int32)
    if int(counts_tab.max()) <= 1:
        # unique build keys: start[slot] = the one arrival position
        pos_tab = torch.full((span_shard,), -1, dtype=torch.int32,
                             device=dev)
        pos_tab[slot_r[inr].long()] = iota[inr]
        gidx = iota
    else:
        # duplicates: stable sort by slot, then each run's first
        # position (an integer min, exact in any order)
        key = torch.where(inr, slot_r, span_shard)
        srt, order = torch.sort(key, stable=True)
        gidx = order.to(torch.int32)
        keep = srt < span_shard
        pos_tab = torch.full((span_shard,), m, dtype=torch.int32,
                             device=dev).scatter_reduce_(
            0, srt[keep].long(), iota[keep], reduce="amin")
    if lmask is None:
        starts, counts = hash_probe(pos_tab, counts_tab, slot_l)
    else:
        starts, counts = masked_hash_probe(pos_tab, counts_tab, slot_l,
                                           lmask)
    return starts, counts, gidx


def _probe_packed(lk: torch.Tensor, rk: torch.Tensor, sent: int):
    """int32 keys in hash mode: one sort of ``key << 32 | arrival``
    orders the build side by key with ties in arrival order, so the
    grouped layout and ``gidx`` come from one sort; the probe is a
    binary search, and the count a hit check when the build keys are
    unique, else a second search."""
    m = rk.shape[0]
    iota = torch.arange(m, dtype=torch.int64, device=rk.device)
    packed, _ = torch.sort((rk.long() << 32) | iota)
    k_srt = (packed >> 32).to(torch.int32)
    gidx = (packed & 0xFFFFFFFF).to(torch.int32)
    starts = torch.searchsorted(k_srt, lk)
    dup = bool(((k_srt[1:] == k_srt[:-1]) & (k_srt[1:] != sent)).any())
    if dup:
        ends = torch.searchsorted(k_srt, lk, right=True)
        counts = torch.where(lk != sent, ends - starts, 0)
    else:
        hit = (k_srt[starts.clamp(max=m - 1)] == lk) & (lk != sent)
        counts = hit.to(torch.int64)
    return starts.to(torch.int32), counts.to(torch.int32), gidx


def _probe_wide(lk: torch.Tensor, rk: torch.Tensor, sent: int):
    """int64 keys in hash mode: a stable sort (ties keep arrival order)
    and two binary searches."""
    k_srt, order = torch.sort(rk, stable=True)
    starts = torch.searchsorted(k_srt, lk)
    ends = torch.searchsorted(k_srt, lk, right=True)
    counts = torch.where(lk != sent, ends - starts, 0)
    return (starts.to(torch.int32), counts.to(torch.int32),
            order.to(torch.int32))


# ---------------------------------------------------------------------------
# partial aggregation (torch, on a partition's card)
# ---------------------------------------------------------------------------

def _reduce(values: torch.Tensor, gid: torch.Tensor, ok: torch.Tensor, *,
            nseg: int, stats: set) -> dict:
    """One source partition's partials over all ``nseg`` slots: the
    COUNT, and SUM / MIN / MAX as ``stats`` asks. The counts come from
    the first kernel that runs (a SUM, else a MIN or MAX)."""
    got = {}
    if "sum" in stats or not stats:
        got["sum"], got["count"] = masked_segment_sum(values, gid, ok, nseg)
        if "sum" not in stats:
            del got["sum"]              # a COUNT alone
    for op in ("min", "max"):
        if op in stats:
            got[op], count = masked_segment_reduce(values, gid, ok, nseg,
                                                   op=op)
            got.setdefault("count", count)
    return got


def _gather(parts: list, card: torch.device, at: torch.Tensor
            ) -> torch.Tensor:
    """The owners' slot ranges, in order, on ``card``, at slots ``at``."""
    full = (parts[0].to(card) if len(parts) == 1 else
            torch.cat([t.to(card) for t in parts]))
    return full.index_select(0, at)


# ---------------------------------------------------------------------------
# host layout
# ---------------------------------------------------------------------------

def _layout(keys: np.ndarray, ndev: int, span_shard: int
            ) -> tuple[np.ndarray, np.ndarray, int]:
    """``(key slabs, row-index slabs, cap)`` of shape ``(src, owner,
    cap)``; one partition is the identity layout (no copy, no padding:
    unmatchable rows stay and match nothing)."""
    if ndev == 1:
        n = len(keys)
        return (keys.reshape(1, 1, n),
                np.arange(n, dtype=np.int32).reshape(1, 1, n), n)
    return _partition(keys, _buckets(keys, ndev, span_shard), ndev)


def _buckets(keys: np.ndarray, ndev: int, span_shard: int) -> np.ndarray:
    """Owner partition per row, uint8; ``ndev`` for unmatchable rows
    (never placed).

    Range mode is one shift: span_shard is a power of two, so valid
    codes shift below ndev and the int32 sentinel to at least 16*ndev,
    and clipping to ndev (the drop bucket) is exact."""
    if span_shard > 0:
        sh = span_shard.bit_length() - 1
        return np.minimum(keys >> sh, ndev).astype(np.uint8)
    sent = _sentinel(keys.dtype)
    if keys.dtype.itemsize > 4:
        folded = ((keys >> 32) ^ keys).astype(np.int32)
    else:
        folded = keys.astype(np.int32)
    b = _mix32(folded).astype(np.int64) % ndev
    return np.where(keys != sent, b, ndev).astype(np.uint8)


def _partition(keys: np.ndarray, buckets: np.ndarray, ndev: int
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Host partition into ``(src, owner, cap)`` slabs: rows split into
    ``ndev`` source chunks, each chunk's rows counting-sorted by owner
    (numpy's stable integer argsort), padded with the sentinel and row
    index -1. Stable per (src, owner): rows keep their order."""
    n = len(keys)
    chunk = -(-n // ndev)
    counts = np.bincount(
        (np.arange(n, dtype=np.int64) // chunk) * (ndev + 1) + buckets,
        minlength=ndev * (ndev + 1)).reshape(ndev, ndev + 1)
    cap = _round_cap(int(counts[:, :ndev].max()))
    slab = np.full((ndev, ndev, cap), _sentinel(keys.dtype),
                   dtype=keys.dtype)
    idx = np.full((ndev, ndev, cap), -1, dtype=np.int32)
    for s in range(ndev):
        lo = s * chunk
        hi = min(n, lo + chunk)
        if lo >= hi:
            continue
        order = np.argsort(buckets[lo:hi], kind="stable")
        ks = keys[lo:hi][order]
        rows = (order + lo).astype(np.int32)
        off = 0
        for d in range(ndev):
            c = int(counts[s, d])
            slab[s, d, :c] = ks[off:off + c]
            idx[s, d, :c] = rows[off:off + c]
            off += c
    return slab, idx, cap
