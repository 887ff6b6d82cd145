"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of ``repro/models/xlstm.py`` (arXiv:2405.04517). Both use
exponential gating with the paper's max-state stabilizer.

- **mLSTM**: the prefill (no state) runs the chunkwise mLSTM kernel
  (:func:`repro_torch.kernels.mlstm.ops.mlstm`) on (B·H, S, hd) views,
  where ``repro``'s model runs its XLA chunk (``_mlstm_chunk``) under a
  ``lax.scan`` over chunks of 256; the two compute the same function,
  and the tests hold the port's path against ``repro``'s. With a state
  (decode, one token) the port runs the same chunk in plain torch and
  reaches no kernel, as in ``repro``; a longer input with a state is
  refused, since nothing serves one.
- **sLSTM**: hidden-to-hidden recurrence, block-diagonal per head, so it
  is sequential: a Python loop over S in plain torch (``repro`` scans
  it, and has no Pallas kernel for it). ``repro`` broadcasts the
  recurrent weights over the batch before its scan to keep a gradient
  sharded under GSPMD; the port's DTensor step reduces a replicated
  weight's gradient once, after the backward, so it does not.

Under sharding rules the tensors carry ``repro``'s logical tags
(``lshard``) and the mLSTM kernel takes each rank's own batch rows and
heads (``sharding.local_call``).

Dtypes follow ``repro``: projections in ``cfg.dtype``, gates, states and
the recurrences in float32, the mixed output cast back to ``x.dtype``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (local_call, lshard, merge_last,
                                              split_last)
from repro_torch.kernels.mlstm.ops import mlstm
from repro_torch.models.layers import Params, dense_spec, mm

__all__ = ["mlstm_params", "mlstm_forward", "mlstm_state_init",
           "slstm_params", "slstm_forward", "slstm_state_init"]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_params(cfg: ModelConfig) -> dict[str, tuple]:
    d, hd, H = cfg.d_model, cfg.head_dim, cfg.num_heads
    dt = getattr(torch, cfg.param_dtype)
    return {
        "wq": dense_spec((d, H * hd), dt),
        "wk": dense_spec((d, H * hd), dt),
        "wv": dense_spec((d, H * hd), dt),
        "wo": dense_spec((H * hd, d), dt),
        "w_if": dense_spec((d, 2 * H), torch.float32, scale=0.01),
        # input gate bias 0, forget gate bias 3.0
        "b_if": ((2 * H,), torch.float32, ("halves", 0.0, 3.0)),
    }


def _mlstm_chunk(q, k, v, log_i, log_f, C0, n0, m0):
    """One chunk, parallel within and recurrent across, in plain torch.

    q, k, v: (B, H, L, hd); log_i, log_f: (B, H, L); the state C0 (B, H,
    hd, hd), n0 (B, H, hd), m0 (B, H). Returns (out, C1, n1, m1), out
    float32.
    """
    L, hd = q.shape[-2], q.shape[-1]
    Fc = torch.cumsum(log_f, dim=-1)                         # (B, H, L)
    m_intra = Fc[..., :, None] - Fc[..., None, :] + log_i[..., None, :]
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    m_intra = torch.where(causal, m_intra, float("-inf"))    # (B, H, L, L)
    m_state = Fc + m0[..., None]
    m_new = torch.maximum(m_intra.amax(-1), m_state).clamp_min(-1e30)
    d_intra = torch.exp(m_intra - m_new[..., None])
    d_state = torch.exp(m_state - m_new)

    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    sd = torch.einsum("bhld,bhjd->bhlj", qf, kf) * scale * d_intra
    intra = torch.einsum("bhlj,bhjd->bhld", sd, vf)
    inter = torch.einsum("bhld,bhde->bhle", qf * scale, C0) \
        * d_state[..., None]
    qn = torch.einsum("bhld,bhd->bhl", qf * scale, n0)
    denom = (sd.sum(-1) + qn * d_state).abs()
    denom = torch.maximum(denom, torch.exp(-m_new))
    out = (intra + inter) / denom[..., None]

    F_tot = Fc[..., -1]                                      # (B, H)
    m1 = torch.maximum(F_tot + m0,
                       (F_tot[..., None] - Fc + log_i).amax(-1))
    w_state = torch.exp(F_tot + m0 - m1)
    w_in = torch.exp(F_tot[..., None] - Fc + log_i - m1[..., None])
    C1 = C0 * w_state[..., None, None] + torch.einsum(
        "bhld,bhle,bhl->bhde", kf, vf, w_in)
    n1 = n0 * w_state[..., None] + torch.einsum("bhld,bhl->bhd", kf, w_in)
    return out, C1, n1, m1


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: dict | None = None, chunk: int = 256):
    """x: (B, S, d). ``state`` {"C", "n", "m"} in decode (S = 1), else
    None. Returns (out, new state or None)."""
    S = x.shape[1]
    H, hd = cfg.num_heads, cfg.head_dim

    def heads(name):
        return split_last(mm(x, p[name]), H, hd).transpose(1, 2)

    q, k, v = (lshard(heads(n), "batch", "heads", "seq", "head_dim")
               for n in ("wq", "wk", "wv"))                  # (B, H, S, hd)
    gates = x.float() @ p["w_if"] + p["b_if"]                # (B, S, 2H)
    log_i = gates[..., :H].transpose(1, 2)                   # (B, H, S)
    log_f = _logsigmoid(gates[..., H:]).transpose(1, 2)

    if state is None:
        h = local_call(_mlstm_heads, q, k, v, log_i, log_f, lead=2,
                       chunk=chunk)
        new_state = None
    else:   # one decode step from a carried state: repro's chunk
        if S != 1:
            raise ValueError(f"a carried state takes one token, not {S}")
        h, C, n, m = _mlstm_chunk(q, k, v, log_i, log_f,
                                  state["C"], state["n"], state["m"])
        new_state = {"C": C, "n": n, "m": m}
    out = merge_last(h.transpose(1, 2)).to(x.dtype)
    return lshard(mm(out, p["wo"]), "batch", "seq", "embed"), new_state


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))``, element-wise; on a DTensor each rank takes its
    own elements (``local_call``): DTensor has no sharding rule for this
    op's backward."""
    return local_call(F.logsigmoid, x, lead=x.ndim)


def _mlstm_heads(q, k, v, log_i, log_f, *, chunk: int):
    """The kernel over (B, H, S, hd) heads, flattened to (B·H, S, hd)
    and back."""
    B, H, S, hd = q.shape

    def flat(t):
        return t.reshape(B * H, *t.shape[2:]).contiguous()
    return mlstm(flat(q), flat(k), flat(v), flat(log_i), flat(log_f),
                 chunk=chunk).view(B, H, S, hd)


def mlstm_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    H, hd = cfg.num_heads, cfg.head_dim
    z = lambda *shape: torch.zeros(batch, *shape, dtype=torch.float32,
                                   device=device)
    return {"C": z(H, hd, hd), "n": z(H, hd), "m": z(H)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_params(cfg: ModelConfig) -> dict[str, tuple]:
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H
    dt = getattr(torch, cfg.param_dtype)
    return {
        # input projections for the gates i, f, z, o: (d, 4d)
        "w_in": dense_spec((d, 4 * d), dt),
        # block-diagonal recurrent weights per head: (4, H, hd, hd)
        "r": dense_spec((4, H, hd, hd), torch.float32, scale=0.05),
        "b": ((4 * d,), torch.float32, "zeros"),
        "w_out": dense_spec((d, d), dt),
    }


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: dict | None = None):
    """x: (B, S, d). ``state`` {"c", "n", "m", "h"} in decode, else None.
    Returns (out, new state or None)."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H
    # the gates whole on every rank: the recurrence unbinds them, which
    # DTensor cannot do on a dim split over the model axis (the model
    # axis replicates the sLSTM's loop)
    zx = lshard(mm(x, p["w_in"]), "batch", "seq", None)
    zx = (zx.float() + p["b"]).reshape(B, S, 4, H, hd)
    st = state if state is not None else slstm_state_init(cfg, B, x.device)
    c, n, m, h = st["c"], st["n"], st["m"], st["h"]          # (B, H, hd)
    # r (4, H, hd, hd) as (H, hd, 4 hd): one batched product per step
    r = p["r"].permute(1, 2, 0, 3).reshape(H, hd, 4 * hd)
    hs = []
    for t in range(S):
        rec = torch.bmm(h.transpose(0, 1), r)                 # (H, B, 4 hd)
        z = zx[:, t] + rec.view(H, B, 4, hd).permute(1, 2, 0, 3)
        i_t, f_t, z_in, o_t = z.unbind(1)
        lfm = _logsigmoid(f_t) + m
        m_new = torch.maximum(lfm, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(lfm - m_new)
        c = f_p * c + i_p * torch.tanh(z_in)
        n = f_p * n + i_p
        h = torch.sigmoid(o_t) * c / n.clamp_min(1.0)
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1)                              # (B, S, H, hd)
    y = lshard(mm(hs.reshape(B, S, d).to(x.dtype), p["w_out"]),
               "batch", "seq", "embed")
    new_state = ({"c": c, "n": n, "m": m, "h": h}
                 if state is not None else None)
    return y, new_state


def slstm_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    H = cfg.num_heads
    hd = cfg.d_model // H
    z = lambda: torch.zeros(batch, H, hd, dtype=torch.float32,
                            device=device)
    return {"c": z(), "n": z(), "m": z(), "h": z()}
