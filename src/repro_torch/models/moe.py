"""Mixture-of-Experts layer: GShard-style grouped top-k routing.

The port of ``repro/models/moe.py``, with its semantics kept exactly:

- Tokens are routed in fixed-size *groups*: ``g`` is the largest divisor
  of S not above ``cfg.moe.group_size``. Each expert takes at most
  ``c = _capacity(cfg)`` (token, slot) pairs of a group, in token order
  then slot order; the rest are dropped and the surviving gates of a
  token renormalized (``cfg.norm_topk_prob``, ``repro``'s rule; with
  it False, as DeepSeek-V2 states, the kept gates are the router's
  probabilities, 0 where dropped). ``c`` is computed from
  ``group_size``, not from ``g``: a one-token decode step gets the same
  ``c`` and drops nothing.
- The router runs in float32; its top-k breaks ties toward the lower
  expert index, as ``jax.lax.top_k`` does (a stable sort, not
  ``torch.topk``, which promises no order among equal values).
- Dispatch gathers each kept pair's token into its (expert, slot); the
  gathered tokens are rounded to bfloat16 whatever the config's dtype,
  as in ``repro``, and the expert products promote them against the
  weights. The combine gathers each pair's expert output back in
  float32 and gate-sums it; the output is cast to the input's dtype.
- The load-balancing aux loss (Shazeer et al.) counts the top-k choices
  before the drop; each sequence chunk of groups gives one, and the
  layer returns their mean.

``repro`` scans the sequence chunks one by one; groups are independent,
so the port routes all ``n * B`` groups of a call at once (the same
numbers, fewer launches). Every shape is fixed by the config and the
input's: the token index of each (expert, slot) is written by a plain
``scatter_`` of unique indices, a dropped pair writing one spare column
past ``E·c`` that is cut off afterwards (``repro``'s ``mode="drop"``),
and the tokens and outputs are gathered by integer index. No
``index_add_``/``scatter_add_`` on floats, whose atomics would make the
result vary from run to run, and nothing whose shape depends on the
data, so the layer runs on ``meta`` too.

The dispatched tokens keep a batch dim, ``xin`` (B, E, n·c, d), tagged
``("batch", experts, "expert_cap", "embed")`` as ``repro``'s (B, E, c,
d) is, the n chunks of a row side by side in the capacity dim. The
expert products are plain batched matrix products over the stacked
(E, d, f) weights (``torch.bmm``): ``repro`` leaves them to XLA outside
any Pallas kernel.

Under sharding rules (``distributed/sharding.py``) each step runs on
each rank's own shards (``local_map``), because DTensor has no rule for
the routing's sort, one-hot and cumulative sum, or for gathers by
integer index:

- The sequence is made whole first (a sequence-parallel residual is
  gathered over ``model``), so that groups can be cut from it; rows stay
  split over the ``batch`` axes, and every rank of the expert axis
  routes the same rows the same way.
- Expert parallelism (the expert count divides the ``experts`` axis):
  each rank gathers the slots of its own experts from its replicated
  tokens, which moves nothing, and runs its experts' products.
- Otherwise (granite's 40 experts on a 16-wide ``model`` axis) the
  weights fall back to tensor parallelism inside each expert
  (``elastic.param_spec``): every rank runs every expert on its slice of
  the expert's ``ff`` dim, and its outputs are partial sums.
- The combine is a sum over experts: each rank gate-sums the outputs it
  holds, in float32, and the ranks add the (B, S, d) results (a
  reduction of the same size as a dense layer's tensor-parallel one).
  The ranks never exchange the (B, E, n·c, d) slots.

The gradients follow the same placements: a weight's gradient is a
partial sum over the ``batch`` axes, and the gradient of the tokens and
the gates a partial sum over the axes that split the experts.

Under ``obs.tracing()`` the layer records a span per step:
``moe.route`` (the decisions), ``moe.dispatch`` (the slots' tokens),
``moe.experts`` (the two products), ``moe.combine`` (the gate-sum and
the cast) and ``moe.shared`` (the shared expert, where there is one,
an MLP of ``cfg.shared_d_ff``), and two counts that say how full the
slots are: the device tally ``moe.pairs_kept``, the (token, expert)
pairs this rank's decisions keep, and the counter ``moe.slots``, the
slots its experts' products run on, ``B · E_l · n · c``. The tally adds two small kernels
a layer, under ``moe.route``, and only while tracing.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (axis_sizes, current_rules,
                                              lshard, placements, safe_spec)
from repro_torch.models import layers as L
from repro_torch.obs import get_recorder

__all__ = ["MoE", "moe_params", "group_size", "route", "moe_forward"]


def moe_params(cfg: ModelConfig) -> tuple[dict, dict]:
    """The specs of the float32 router (d, E) and of the stacked expert
    weights, (E, d, f) and (E, f, d) at ``repro``'s scales."""
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.num_experts
    dt = getattr(torch, cfg.param_dtype)
    up = L.dense_spec((E, d, f), dt, scale=1 / math.sqrt(d))
    down = L.dense_spec((E, f, d), dt, scale=1 / math.sqrt(f))
    experts = ({"w_gate": up, "w_up": up, "w_down": down}
               if cfg.act == "swiglu" else {"w_up": up, "w_down": down})
    return {"router": L.dense_spec((d, E), torch.float32, scale=0.02)}, experts


class MoE(L.ParamModule):
    """``router`` (d, E) float32; ``experts``: ``w_gate``/``w_up`` (E, d,
    f) and ``w_down`` (E, f, d); ``shared``, an MLP, when the config has a
    shared expert. Names as in ``repro``'s ``ffn`` tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        router, experts = moe_params(cfg)
        super().__init__(router, device)
        self.experts = L.ParamModule(experts, device)
        if cfg.moe.shared_expert:
            self.shared = L.ParamModule(
                L.mlp_params(cfg, cfg.shared_d_ff), device)


def _capacity(cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(math.ceil(m.group_size * m.experts_per_token / m.num_experts
                      * m.capacity_factor))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def group_size(cfg: ModelConfig, S: int) -> int:
    """The largest divisor of S not above ``cfg.moe.group_size``."""
    g = min(cfg.moe.group_size, S)
    while S % g:
        g -= 1
    return g


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, T, a) @ (E, a, b) in the promoted dtype, as JAX's einsum."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.bmm(x, w)


def route(p, xg: torch.Tensor, cfg: ModelConfig):
    """The routing decisions of groups ``xg`` (..., g, d): ``probs``
    (..., g, E) float32, ``expert_idx`` (..., g, k), ``pos`` (..., g, k)
    each pair's place in its expert's queue, ``keep`` (..., g, k) ``pos <
    c``, and the ``gates`` (..., g, k) float32 (0 where dropped),
    renormalized unless ``norm_topk_prob`` is False."""
    m = cfg.moe
    E, k, c = m.num_experts, m.experts_per_token, _capacity(cfg)
    *lead, g, _ = xg.shape
    probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
    # top-k with ties toward the lower expert index, as jax.lax.top_k
    gates, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gates, expert_idx = gates[..., :k], expert_idx[..., :k]
    onehot = F.one_hot(expert_idx, E).to(torch.int32)        # (..., g, k, E)
    flat = onehot.reshape(*lead, g * k, E)
    pos = ((flat.cumsum(-2) - flat) * flat).sum(-1).reshape(*lead, g, k)
    keep = pos < c
    gates = gates * keep
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, expert_idx, pos, keep, gates


def _expert_axis_tag(E: int) -> str | None:
    """The expert activations' logical tag: ``"experts"`` when the
    expert count divides the mesh's expert axis, else None (the weights
    then fall back to intra-expert TP, ``elastic.param_spec``), as in
    ``repro``."""
    r = current_rules()
    if r is None or r.mesh is None:
        return "experts"
    ent = r.rules.get("experts")
    sizes = axis_sizes(r.mesh)
    size = 1
    for ax in (ent if isinstance(ent, tuple) else (ent,)):
        size *= sizes.get(ax, 1)
    return "experts" if size and E % size == 0 else None


# ---------------------------------------------------------------------------
# the steps, each on one rank's tensors
# ---------------------------------------------------------------------------

def _groups(x: torch.Tensor, g: int) -> torch.Tensor:
    """x (B, S, d) as its groups, chunk-major: (n, B, g, d), a view."""
    B, S, d = x.shape
    return x.reshape(B, S // g, g, d).transpose(0, 1)


def _decide(x, router, *, cfg: ModelConfig, g: int):
    """Route the rows x (B, S, d): the decisions (n, B, g, k) each, and
    per chunk the sums over the rows' tokens of the top-k counts and of
    the probabilities, (n, E) float32 each (the aux loss's terms)."""
    E = cfg.moe.num_experts
    # ``route`` is looked up here, at the call: the chip smoke, the tests
    # and the benchmark's judge wrap the module's attribute to record the
    # decisions
    probs, expert_idx, pos, keep, gates = route({"router": router},
                                                _groups(x, g), cfg)
    rec = get_recorder()
    if rec.enabled:
        rec.metrics.tally("moe.pairs_kept").add(keep.sum())
    n = probs.shape[0]
    counts = torch.zeros((n, E), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, expert_idx.reshape(n, -1),
                        torch.ones_like(expert_idx).reshape(n, -1))
    return (expert_idx, pos, keep, gates, counts.float(),
            probs.reshape(n, -1, E).sum(1))


def _dispatch(x, expert_idx, pos, keep, *, cfg: ModelConfig, e0: int,
              E_l: int):
    """The tokens of experts ``e0 .. e0+E_l-1``' slots: (B, E_l, n·c,
    d) bfloat16, zeros in an empty slot; laid out (E_l, B, n·c, d) in
    memory, the products' layout (the result is a transposed view)."""
    n, B, g, k = expert_idx.shape
    d = x.shape[-1]
    E, c = cfg.moe.num_experts, _capacity(cfg)
    dev = x.device
    rec = get_recorder()
    if rec.enabled:
        rec.metrics.counter("moe.slots").inc(B * E_l * n * c)
    # the token index of each (expert, slot); g, the index of an appended
    # zero row, marks an empty slot, and a dropped pair writes the spare
    # column E*c, cut off below
    col = torch.where(keep, expert_idx * c + pos, E * c).reshape(n, B, -1)
    toks = torch.arange(g, device=dev)[:, None].expand(n, B, g, k)
    src = torch.full((n, B, E * c + 1), g, dtype=torch.long, device=dev)
    src.scatter_(2, col, toks.reshape(n, B, -1))
    src = src[..., :E * c].reshape(n, B, E, c)[:, :, e0:e0 + E_l]
    xpad = torch.cat([_groups(x.to(torch.bfloat16), g),
                      x.new_zeros((n, B, 1, d), dtype=torch.bfloat16)],
                     dim=2)                              # (n, B, g+1, d)
    xin = xpad[torch.arange(n, device=dev)[None, None, :, None],
               torch.arange(B, device=dev)[None, :, None, None],
               src.permute(2, 1, 0, 3)]                  # (E_l, B, n, c, d)
    return xin.reshape(E_l, B, n * c, d).transpose(0, 1)


def _up(xin, *w):
    """(B, E_l, C, d) -> h (B, E_l, C, f): the experts' activations."""
    B, El, C, d = xin.shape
    xe = xin.transpose(0, 1).reshape(El, B * C, d)
    if len(w) == 2:
        h = F.silu(_bmm(xe, w[0])) * _bmm(xe, w[1])
    else:                           # jax.nn.gelu is the tanh approximation
        h = F.gelu(_bmm(xe, w[0]), approximate="tanh")
    return h.reshape(El, B, C, -1).transpose(0, 1)


def _down(h, w_down):
    """h (B, E_l, C, f) -> (B, E_l, C, d): the experts' outputs."""
    B, El, C, f = h.shape
    out = _bmm(h.transpose(0, 1).reshape(El, B * C, f), w_down)
    return out.reshape(El, B, C, -1).transpose(0, 1)


def _combine(eout, expert_idx, pos, keep, gates, *, cfg: ModelConfig,
             e0: int):
    """Each pair's output from the experts ``eout`` (B, E_l, n·c, d)
    holds (``e0`` the first), gate-summed in float32: (B, S, d). A pair
    of another rank's expert, or dropped, adds 0."""
    n, B, g, k = expert_idx.shape
    E_l, d = eout.shape[1], eout.shape[-1]
    c = _capacity(cfg)
    dev = eout.device
    own = keep & (expert_idx >= e0) & (expert_idx < e0 + E_l)
    col = (torch.arange(n, device=dev)[:, None, None, None] * c
           + pos.clamp_max(c - 1))
    picked = eout[torch.arange(B, device=dev)[None, :, None, None],
                  (expert_idx - e0).clamp(0, E_l - 1), col].float()
    # own is 0 or 1: masking the gates masks each pair's product alike,
    # without a pass over the (n, B, g, k, d) pairs
    out = torch.einsum("nbgkd,nbgk->nbgd", picked, gates * own)
    return out.transpose(0, 1).reshape(B, n * g, d)


# ---------------------------------------------------------------------------
# placements under rules
# ---------------------------------------------------------------------------

class _Split:
    """How the mesh splits the layer: the mesh dims of the batch, of the
    experts (expert parallelism) and of each expert's ff dim (the
    tensor-parallel fallback), read from the tags' placements; this
    rank's first expert ``e0`` and its count ``E_l``. Without a mesh
    (off the rules) no dim is split, and each step is a plain call."""

    def __init__(self, mesh, B: int, E: int, C: int, d: int, f: int,
                 etag: str | None):
        self.mesh = mesh
        self.batch = self.experts = self.ff = ()
        self.e0, self.E_l = 0, E
        if mesh is None:
            return
        r = current_rules()

        def shard_dims(spec, shape, dim):
            pl = placements(safe_spec(spec, shape, mesh), mesh)
            return tuple(md for md, p in enumerate(pl)
                         if p.is_shard() and p.dim == dim)

        xin_spec = r.resolve("batch", etag, "expert_cap", "embed")
        self.batch = shard_dims(xin_spec, (B, E, C, d), 0)
        self.experts = shard_dims(xin_spec, (B, E, C, d), 1)
        self.ff = shard_dims(r.resolve("batch", etag, "expert_cap", "ff"),
                             (B, E, C, f), 3)
        idx = 0
        for md in self.experts:            # torch.chunk's split, in order
            idx = idx * mesh.size(md) + mesh.get_local_rank(md)
            self.E_l //= mesh.size(md)
        self.e0 = idx * self.E_l

    def pl(self, shard: dict | None = None, partial=()) -> list | None:
        """Placements: mesh dim -> Shard(tensor dim) from ``shard``,
        Partial on ``partial``, Replicate elsewhere (None off the
        rules)."""
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Partial, Replicate, Shard
        out = [Replicate()] * self.mesh.ndim
        for mds, dim in (shard or {}).items():
            for md in mds:
                out[md] = Shard(dim)
        for md in partial:
            out[md] = Partial()
        return out

    def call(self, fn, args, ins, outs, grads=None):
        """``fn`` on each rank's shards of ``args`` (placed as ``ins``;
        a plain tensor counts as replicated), its outputs ``outs``; the
        gradient of each argument placed as ``grads`` (default ``ins``).
        Off the rules, ``fn(*args)``."""
        if self.mesh is None:
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.experimental import local_map
        placed = []
        for a, want in zip(args, ins):
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, self.mesh,
                                       [Replicate()] * self.mesh.ndim,
                                       run_check=False)
            placed.append(a if list(a.placements) == want
                          else a.redistribute(self.mesh, want))
        return local_map(fn, out_placements=outs, in_placements=tuple(ins),
                         in_grad_placements=tuple(grads or ins),
                         device_mesh=self.mesh)(*placed)


def _under_rules(x) -> bool:
    from torch.distributed.tensor import DTensor
    r = current_rules()
    return (r is not None and r.mesh is not None
            and isinstance(x, DTensor))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def moe_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar).
    Groups are contiguous token chunks of each sequence."""
    m = cfg.moe
    B, S, d = x.shape
    E, k, c = m.num_experts, m.experts_per_token, _capacity(cfg)
    g = group_size(cfg, S)
    n = S // g
    ew = p["experts"]
    w_in = [ew[name] for name in ("w_gate", "w_up") if name in ew]
    w_down = ew["w_down"]
    etag = _expert_axis_tag(E)
    # the sequence whole (a sequence-parallel residual is gathered), the
    # rows split over the batch axes: each rank cuts its rows' groups
    xs = lshard(x, "batch", None, "embed")
    sp = _Split(xs.device_mesh if _under_rules(xs) else None, B, E, n * c,
                d, w_down.shape[-2], etag)
    bt, ex, ff, pl = sp.batch, sp.experts, sp.ff, sp.pl
    span = get_recorder().span
    # (n, B, g, k) decisions: rows split as x's (tensor dim 1)
    rows, dec_pl = pl({bt: 0}), pl({bt: 1})
    with span("moe.route"):
        dec = sp.call(partial(_decide, cfg=cfg, g=g), (xs, p["router"]),
                      [rows, pl()], (dec_pl,) * 4 + (pl(partial=bt),) * 2,
                      [rows, pl(partial=bt)])
    with span("moe.dispatch"):
        xin = sp.call(partial(_dispatch, cfg=cfg, e0=sp.e0, E_l=sp.E_l),
                      (xs, *dec[:3]), [rows] + [dec_pl] * 3,
                      pl({bt: 0, ex: 1}),
                      [pl({bt: 0}, partial=ex)] + [dec_pl] * 3)
        xin = lshard(xin, "batch", etag, "expert_cap", "embed")
    with span("moe.experts"):
        h = sp.call(_up, (xin, *w_in),
                    [pl({bt: 0, ex: 1})] + [pl({ex: 0, ff: 2})] * len(w_in),
                    pl({bt: 0, ex: 1, ff: 3}),
                    [pl({bt: 0, ex: 1}, partial=ff)]
                    + [pl({ex: 0, ff: 2}, partial=bt)] * len(w_in))
        h = lshard(h, "batch", etag, "expert_cap", "ff")
        eout = sp.call(_down, (h, w_down),
                       [pl({bt: 0, ex: 1, ff: 3}), pl({ex: 0, ff: 1})],
                       pl({bt: 0, ex: 1}, partial=ff),
                       [pl({bt: 0, ex: 1, ff: 3}),
                        pl({ex: 0, ff: 1}, partial=bt)])
        if etag is not None:
            # under the fallback eout is a partial sum over the ff shards:
            # the ranks add the combine's (B, S, d) instead of these slots
            eout = lshard(eout, "batch", etag, "expert_cap", "embed")
    with span("moe.combine"):
        out = sp.call(partial(_combine, cfg=cfg, e0=sp.e0),
                      (eout, *dec[:4]),
                      [pl({bt: 0, ex: 1}, partial=ff)] + [dec_pl] * 4,
                      pl({bt: 0}, partial=ex + ff),
                      [pl({bt: 0, ex: 1})] + [dec_pl] * 3
                      + [pl({bt: 1}, partial=ex + ff)])
        # the ranks' float32 partial sums added, then cast
        out = lshard(out, "batch", "seq", "embed").to(x.dtype)
    if "shared" in p:
        with span("moe.shared"):
            out = out + L.mlp_forward(p["shared"], x, cfg)
    # load-balance aux per chunk: E * sum_e f_e * P_e / k, f_e before drop
    f_e, P_e = dec[4] / (B * g), dec[5] / (B * g)
    aux = E * (f_e * P_e).sum(-1) / k
    return lshard(out, "batch", "seq", "embed"), aux.mean()
