"""Loop-aware HLO analysis and the torch step count: FLOPs, collective
bytes, roofline terms.

The port of ``repro/roofline/analysis.py``. :func:`analyze_hlo` is
``repro``'s, unchanged: pure text parsing of optimized HLO (the call
graph, each ``while`` loop's trip count, ``dot``/``convolution`` FLOPs
and collective operand bytes multiplied by the enclosing trip counts;
elementwise FLOPs ignored), so it reads any HLO text it is given.

The port has no HLO. :func:`analyze_step` is its counterpart: it runs a
step (on ``meta`` tensors, so nothing is allocated) under

- ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``), which count matrix products and convolutions and
  ignore elementwise work, as the HLO count does, each op at the share
  of it this rank runs; plus the FLOPs each hand-written kernel's
  wrapper reports for a ``meta`` call (``count_kernel_flops``): the
  kernel's own work
  (flash: 4·hd per live (query, key) pair), not its plain version's;
- a dispatch mode that sums the operand bytes of every collective the
  step issues (DTensor's redistributions and explicit ones), as the HLO
  count sums collective operands;
- ``saved_tensors_hooks`` that tally the bytes autograd saves for the
  backward pass (the activations a train step holds).

Roofline terms (seconds, per step, whole mesh), with the H100's
constants (``roofline/hw.py``):
    compute    = FLOPs_total   / (chips · PEAK_FLOPS_BF16)
    memory     = HBM bytes     / (chips · HBM_BW)
    collective = coll bytes    / (chips · NVLINK_BW)
"""
from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Callable

import torch

from repro_torch.roofline import hw

__all__ = ["HLOCost", "analyze_hlo", "StepCost", "analyze_step",
           "count_kernel_flops", "Roofline", "roofline_terms"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# Tensors smaller than this inside loop bodies are assumed to stay on
# chip between iterations (the H100's L2 cache: hw.L2_BYTES).
_ON_CHIP_RESIDENT_BYTES = hw.L2_BYTES

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(\([^=]*?\)|\S+)\s+([\w\-]+)\(")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->")


def _parse_type(t: str) -> list[tuple[str, tuple[int, ...]]]:
    """'f32[2,3]{1,0}' or '(f32[2], s32[])' -> [(dtype, shape), ...]."""
    out = []
    for m in _SHAPE_RE.finditer(t):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        shape = tuple(int(x) for x in dims.split(",") if x) if dims else ()
        out.append((dt, shape))
    return out


def _nbytes(t: str) -> int:
    total = 0
    for dt, shape in _parse_type(t):
        n = 1
        for d in shape:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class _Op:
    name: str
    type_str: str
    opcode: str
    line: str


@dataclasses.dataclass
class _Computation:
    name: str
    ops: list[_Op]
    text: str


_COMMENT_RE = re.compile(r"/\*.*?\*/")


def _parse_computations(hlo: str) -> dict[str, _Computation]:
    comps: dict[str, _Computation] = {}
    cur: _Computation | None = None
    buf: list[str] = []
    for line in hlo.splitlines():
        # tuple types embed /*index=N*/ comments whose '=' breaks the
        # lazy type matcher — strip all comments first.
        line = _COMMENT_RE.sub("", line)
        if cur is None:
            m = _COMP_HDR_RE.match(line)
            if m and line.rstrip().endswith("{"):
                cur = _Computation(m.group(1), [], "")
                buf = [line]
            continue
        buf.append(line)
        if line.strip() == "}":
            cur.text = "\n".join(buf)
            comps[cur.name] = cur
            cur = None
            continue
        m = _OP_RE.match(line)
        if m:
            cur.ops.append(_Op(m.group(1), m.group(2), m.group(3), line))
    return comps


_KNOWN_TRIPS_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')


def _trip_count(cond: _Computation) -> int:
    """Max integer constant in the condition computation ≈ loop bound."""
    consts = [int(x) for x in
              re.findall(r"constant\((\d+)\)", cond.text)]
    return max(consts) if consts else 1


def _op_trip_count(op: _Op, comps: dict[str, _Computation]) -> int:
    """Trip count of a `while` op: exact backend_config annotation when
    present (XLA loop analysis), else the condition-constant heuristic."""
    m = _KNOWN_TRIPS_RE.search(op.line)
    if m:
        return int(m.group(1))
    condm = re.search(r"condition=%?([\w\.\-]+)", op.line)
    if condm and condm.group(1) in comps:
        return _trip_count(comps[condm.group(1)])
    return 1


def _callees(op: _Op) -> list[tuple[str, str]]:
    """[(kind, computation name)] referenced by this op."""
    out = []
    for attr in ("condition", "body", "calls", "to_apply",
                 "true_computation", "false_computation"):
        m = re.search(rf"{attr}=%?([\w\.\-]+)", op.line)
        if m:
            out.append((attr, m.group(1)))
    m = re.search(r"branch_computations=\{([^}]*)\}", op.line)
    if m:
        for name in m.group(1).split(","):
            out.append(("branch", name.strip().lstrip("%")))
    return out


@dataclasses.dataclass
class HLOCost:
    flops: float
    collective_bytes: float
    collective_ops: dict[str, float]
    dot_count: int
    while_trips: dict[str, int]
    unparsed_dots: int = 0
    hbm_bytes: float = 0.0


def analyze_hlo(hlo: str) -> HLOCost:
    comps = _parse_computations(hlo)
    # entry = the computation whose name contains "main" or the last ENTRY
    entry = None
    m = re.search(r"ENTRY\s+%?([\w\.\-]+)", hlo)
    if m:
        entry = m.group(1)
    if entry not in comps:  # fallback: largest computation
        entry = max(comps, key=lambda c: len(comps[c].ops))

    # propagate multipliers through the call graph
    mult: dict[str, float] = {entry: 1.0}
    order = [entry]
    seen = {entry}
    while order:
        cname = order.pop(0)
        comp = comps.get(cname)
        if comp is None:
            continue
        for op in comp.ops:
            for kind, callee in _callees(op):
                if callee not in comps:
                    continue
                factor = 1.0
                if kind == "body":
                    factor = float(max(_op_trip_count(op, comps), 1))
                child_mult = mult[cname] * factor
                if callee in mult:
                    mult[callee] = max(mult[callee], child_mult)
                else:
                    mult[callee] = child_mult
                if callee not in seen:
                    seen.add(callee)
                    order.append(callee)

    # fusion bodies: their internal ops are not HBM traffic (the fusion
    # op's own output/operands are) — mark computations referenced by a
    # `fusion` op's `calls=`.
    fusion_bodies: set[str] = set()
    for comp in comps.values():
        for op in comp.ops:
            if op.opcode == "fusion":
                for kind, callee in _callees(op):
                    if kind == "calls":
                        fusion_bodies.add(callee)

    # HBM-traffic proxy:
    # every materialized tensor is written once and read ~once, so
    # traffic ≈ 2 · Σ output-bytes of top-level ops (loop-multiplied),
    # skipping metadata-only opcodes. Fusion internals are skipped.
    # In-place updates (dynamic-update-slice, incl. as a fusion root)
    # only touch the update slice — counting the full buffer would
    # overcount a KV-cache append or scan accumulation by trip-count ×
    # buffer/slice. `while`/`call`/`conditional` are skipped: their
    # bodies are traversed with the loop multiplier already.
    _NO_TRAFFIC = {"parameter", "constant", "get-tuple-element", "tuple",
                   "bitcast", "after-all", "partition-id", "replica-id",
                   "while", "call", "conditional"}

    def _dus_update_bytes(comp: _Computation, op: _Op) -> float | None:
        """If op is (a fusion rooted in) dynamic-update-slice, bytes of
        the update operand; else None."""
        if op.opcode == "dynamic-update-slice":
            target = (comp, op)
        elif op.opcode == "fusion":
            body_name = next((c for k, c in _callees(op) if k == "calls"),
                             None)
            body = comps.get(body_name)
            if body is None:
                return None
            root = next((o for o in body.ops
                         if "ROOT" in o.line.split("=")[0]
                         or o is body.ops[-1]), None)
            if root is None or root.opcode != "dynamic-update-slice":
                return None
            target = (body, root)
        else:
            return None
        bcomp, bop = target
        btypes = {o.name: o.type_str for o in bcomp.ops}
        names = re.findall(r"%([\w\.\-]+)",
                           bop.line.split("(", 1)[1])
        if len(names) >= 2 and names[1] in btypes:
            return float(_nbytes(btypes[names[1]]))
        return None

    # name -> type map (per computation, for operand shape lookup)
    flops = 0.0
    coll_bytes = 0.0
    coll_ops: dict[str, float] = {}
    dot_count = 0
    unparsed = 0
    trips_out: dict[str, int] = {}
    hbm = 0.0

    for cname, comp in comps.items():
        m_c = mult.get(cname, 0.0)
        if m_c == 0.0:
            continue
        types = {op.name: op.type_str for op in comp.ops}
        is_body = cname in fusion_bodies
        # parameters: "%p = f32[..] parameter(0)" are ops too (covered)
        for op in comp.ops:
            if not is_body:
                if op.opcode == "parameter" and cname == entry:
                    hbm += _nbytes(op.type_str)  # weights read once/step
                elif op.opcode not in _NO_TRAFFIC:
                    dus = _dus_update_bytes(comp, op)
                    if dus is not None:
                        # in-place append: slice traffic per trip, but the
                        # buffer is materialized at least once
                        hbm += max(2.0 * dus * m_c,
                                   float(_nbytes(op.type_str)))
                    else:
                        b = _nbytes(op.type_str)
                        # per-iteration tensors below the on-chip
                        # threshold never hit HBM (loop carries stay in
                        # L2)
                        if not (m_c > 1.0 and b < _ON_CHIP_RESIDENT_BYTES):
                            hbm += 2.0 * b * m_c
            if op.opcode == "dot":
                out_t = _parse_type(op.type_str)
                if not out_t:
                    unparsed += 1
                    continue
                _, out_shape = out_t[0]
                out_elems = 1
                for d in out_shape:
                    out_elems *= d
                mdim = re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                 op.line)
                ops_m = re.findall(r"%([\w\.\-]+)", op.line.split("(", 1)[1])
                contracted = 1
                if mdim and ops_m:
                    lhs_t = types.get(ops_m[0])
                    if lhs_t:
                        parsed = _parse_type(lhs_t)
                        if parsed:
                            _, lhs_shape = parsed[0]
                            for idx in mdim.group(1).split(","):
                                if idx and int(idx) < len(lhs_shape):
                                    contracted *= lhs_shape[int(idx)]
                if contracted == 1:
                    unparsed += 1
                flops += 2.0 * out_elems * contracted * m_c
                dot_count += 1
            elif op.opcode == "convolution":
                out_t = _parse_type(op.type_str)
                if out_t:
                    _, out_shape = out_t[0]
                    out_elems = 1
                    for d in out_shape:
                        out_elems *= d
                    # kernel size from rhs operand
                    ops_m = re.findall(r"%([\w\.\-]+)",
                                       op.line.split("(", 1)[1])
                    kelems = 1
                    if len(ops_m) > 1 and ops_m[1] in types:
                        parsed = _parse_type(types[ops_m[1]])
                        if parsed:
                            _, kshape = parsed[0]
                            for d in kshape[:-1]:
                                kelems *= d
                    flops += 2.0 * out_elems * kelems * m_c
            else:
                base = op.opcode.replace("-start", "")
                if base in _COLLECTIVES:
                    # payload: operand bytes (names after '(')
                    args = op.line.split("(", 1)[1].split(")", 1)[0]
                    b = 0
                    for nm in re.findall(r"%([\w\.\-]+)", args):
                        if nm in types:
                            b += _nbytes(types[nm])
                    if b == 0:  # fallback: output bytes
                        b = _nbytes(op.type_str)
                    coll_bytes += b * m_c
                    coll_ops[base] = coll_ops.get(base, 0.0) + b * m_c
                elif op.opcode == "while":
                    trips_out[op.name] = _op_trip_count(op, comps)

    return HLOCost(flops=flops, collective_bytes=coll_bytes,
                   collective_ops=coll_ops, dot_count=dot_count,
                   while_trips=trips_out, unparsed_dots=unparsed,
                   hbm_bytes=hbm)


# ---------------------------------------------------------------------------
# The torch step count
# ---------------------------------------------------------------------------

_tally = threading.local()


def count_kernel_flops(kernel: str, flops: float) -> None:
    """Add ``flops`` to the running :func:`analyze_step` under
    ``kernel``'s name (a hand-written kernel's wrapper, called on
    ``meta``, reports its work here); a no-op outside one."""
    active = getattr(_tally, "kernels", None)
    if active is not None:
        active[kernel] = active.get(kernel, 0.0) + float(flops)


# functional and c10d collectives -> the HLO analyzer's names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(t) for t in x)
    return 0


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _step_mode():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class StepTally(TorchDispatchMode):
        """FLOPs of products and operand bytes of collectives, as this
        rank runs them.

        Products take ``torch.utils.flop_counter``'s formulas (the ones
        ``FlopCounterMode`` applies). On a DTensor the mode sees the op
        at its global shapes; each rank computes the share of it that its
        output's placements give it: the output divided over every mesh
        dim where it is a shard or a partial sum (a replicated output is
        computed whole by every rank)."""

        def __init__(self):
            super().__init__()
            self.flops: dict[str, float] = {}
            self.colls: dict[str, float] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            packet = func.overloadpacket
            if packet in flop_registry:
                f = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
                o = _first_tensor(out)
                for md, pl in enumerate(getattr(o, "placements", ())):
                    if pl.is_shard() or pl.is_partial():
                        f /= o.device_mesh.size(md)
                name = str(packet)
                self.flops[name] = self.flops.get(name, 0.0) + f
            ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
            name = _COLLECTIVE_OPS.get(packet.__name__)
            if ns in ("_c10d_functional", "c10d") and name is not None:
                b = _tensor_bytes(args[0]) if args else 0
                self.colls[name] = self.colls.get(name, 0.0) + b
            return out

    return StepTally()


def _local_bytes(t: torch.Tensor) -> int:
    """A tensor's bytes on this rank: a DTensor's local shard."""
    local = getattr(t, "_local_tensor", t)
    return local.numel() * local.element_size()


@dataclasses.dataclass
class StepCost:
    """What one call of a step costs on this rank."""
    flops: float                     # products + kernels
    flops_by_op: dict[str, float]
    kernel_flops: dict[str, float]   # reported by the kernels' wrappers
    collective_bytes: float
    collective_ops: dict[str, float]
    saved_bytes: int                 # saved for the backward pass
    out: Any = None


def analyze_step(fn: Callable, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once and count, on this rank: FLOPs of
    its products (``torch.utils.flop_counter``'s formulas, as
    ``FlopCounterMode`` counts them) and of its hand-written kernels,
    operand bytes of its collectives, and the bytes autograd saves for
    its backward (each tensor once; the leaves that require gradients,
    the parameters, are the caller's arguments and are not counted).
    Call it on ``meta`` tensors to count a step without running it."""
    kernels: dict[str, float] = {}
    seen: set[int] = set()
    saved = [0]

    def pack(t):
        # the forward's saves; a recompute inside the backward is transient
        if torch._C._current_graph_task_id() != -1:
            return t
        if id(t) not in seen and not (t.requires_grad and t.grad_fn is None):
            seen.add(id(t))
            saved[0] += _local_bytes(t)
        return t

    prev = getattr(_tally, "kernels", None)
    _tally.kernels = kernels
    mode = _step_mode()
    try:
        with mode, torch.autograd.graph.saved_tensors_hooks(
                pack, lambda t: t):
            out = fn(*args, **kwargs)
    finally:
        _tally.kernels = prev
    return StepCost(flops=sum(mode.flops.values()) + sum(kernels.values()),
                    flops_by_op=dict(mode.flops), kernel_flops=kernels,
                    collective_bytes=sum(mode.colls.values()),
                    collective_ops=dict(mode.colls), saved_bytes=saved[0],
                    out=out)


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    model_flops: float
    hbm_bytes: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float
    bytes_per_device: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(*, arch: str, shape: str, mesh: str, chips: int,
                   hlo_flops: float, model_flops: float,
                   hbm_bytes: float, collective_bytes: float,
                   bytes_per_device: float = 0.0) -> Roofline:
    """``hlo_flops`` is the counted FLOPs of the whole mesh (the name is
    ``repro``'s row key)."""
    compute_s = hlo_flops / (chips * hw.PEAK_FLOPS_BF16)
    memory_s = hbm_bytes / (chips * hw.HBM_BW)
    collective_s = collective_bytes / (chips * hw.NVLINK_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=hlo_flops, model_flops=model_flops,
        hbm_bytes=hbm_bytes, collective_bytes=collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck,
        useful_ratio=(model_flops / hlo_flops if hlo_flops else 0.0),
        bytes_per_device=bytes_per_device)
