"""Plain PyTorch version of the mLSTM: the exact sequential recurrence.

The counterpart of ``repro/kernels/mlstm/ref.py``. From arXiv:2405.04517,
per head:

    m_t = max(log f_t + m_{t-1}, log i_t)
    i'  = exp(log i_t - m_t);  f' = exp(log f_t + m_{t-1} - m_t)
    C_t = f' C_{t-1} + i' k_t v_t^T
    n_t = f' n_{t-1} + i' k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))

with q scaled by 1/sqrt(hd), float32 throughout, from C = 0, n = 0, m = 0.
A CPU tensor takes this path (``ops.py``); on the card only checks call
it, as the oracle of the chunkwise CUDA kernel.

:func:`mlstm_two_pass_ref` is the CUDA kernel's algebra in plain PyTorch
(each chunk's own state, the sequential combine at the chunk starts, the
outputs): the kernel wrapper's backward recomputes h through it under
autograd (``ops.py``). :func:`mlstm_ref_states` gives the recurrence's
states at the chunk starts; only tests call it.

Both are plain differentiable PyTorch: each step's output is kept in a
list and stacked, so autograd holds no in-place copies.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mlstm_ref", "mlstm_ref_states", "mlstm_two_pass_ref"]


def mlstm_ref(q, k, v, log_i, log_f):
    """q, k, v: (BH, S, hd); log_i, log_f: (BH, S). Returns h (BH, S, hd)
    in float32."""
    return _sequential(q, k, v, log_i, log_f)[0]


def mlstm_ref_states(q, k, v, log_i, log_f, chunk: int):
    """The recurrence's (C, n, m) at the start of each chunk of ``chunk``
    steps: (BH, NC, hd, hd), (BH, NC, hd), (BH, NC)."""
    return _sequential(q, k, v, log_i, log_f, chunk)[1]


def _sequential(q, k, v, log_i, log_f, chunk: int = 0):
    BH, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q = q.float() * scale
    k, v = k.float(), v.float()
    log_i, log_f = log_i.float(), log_f.float()
    C = torch.zeros(BH, hd, hd, dtype=torch.float32, device=q.device)
    n = torch.zeros(BH, hd, dtype=torch.float32, device=q.device)
    m = torch.zeros(BH, dtype=torch.float32, device=q.device)
    outs, starts = [], []
    for t in range(S):
        if chunk and t % chunk == 0:
            starts.append((C, n, m))
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]
        li, lf = log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        i_p = torch.exp(li - m_new)
        f_p = torch.exp(lf + m - m_new)
        C = f_p[:, None, None] * C + i_p[:, None, None] \
            * k_t[:, :, None] * v_t[:, None, :]
        n = f_p[:, None] * n + i_p[:, None] * k_t
        num = torch.einsum("bde,bd->be", C, q_t)
        den = torch.einsum("bd,bd->b", n, q_t).abs()
        den = torch.maximum(den, torch.exp(-m_new))
        outs.append(num / den[:, None])
        m = m_new
    states = tuple(torch.stack(x, dim=1) for x in zip(*starts)) if starts \
        else None
    out = torch.stack(outs, dim=1) if outs else \
        torch.empty(BH, 0, hd, dtype=torch.float32, device=q.device)
    return out, states


def mlstm_two_pass_ref(q, k, v, log_i, log_f, chunk: int = 64):
    """The kernel's three passes over chunks of ``chunk`` steps (S padded
    to a multiple: k = v = 0, log_i = -1e30, log_f = 0), float32:

    1. each chunk's own state, relative to its input stabilizer
       a = max_t(F_end - F_t + log_i_t): C_loc = (k w)^T v, n_loc =
       (k w)^T 1, w_t = exp(F_end - F_t + log_i_t - a);
    2. the states at the chunk starts, in order: m1 = max(F_end + m, a),
       C <- C exp(F_end + m - m1) + C_loc exp(a - m1), likewise n;
    3. the outputs from the state at the chunk's start and the chunk.

    Returns (h (BH, S, hd), (C, n, m) at each chunk's start)."""
    BH, S, hd = q.shape
    L = chunk
    NC = -(-S // L)
    pad = NC * L - S
    neg = -1e30
    q = torch.nn.functional.pad(q.float() / math.sqrt(hd), (0, 0, 0, pad))
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    li = torch.nn.functional.pad(log_i.float(), (0, pad), value=neg)
    lf = torch.nn.functional.pad(log_f.float(), (0, pad))
    q, k, v = (x.reshape(BH, NC, L, hd) for x in (q, k, v))
    li, F = li.reshape(BH, NC, L), torch.cumsum(lf.reshape(BH, NC, L), -1)
    f_end = F[..., -1]
    # 1. each chunk's own state
    a = (f_end[..., None] - F + li).amax(-1)
    w = torch.exp(f_end[..., None] - F + li - a[..., None])
    kw = k * w[..., None]
    c_loc = kw.transpose(-1, -2) @ v
    n_loc = kw.sum(-2)
    # 2. the states at the chunk starts
    C = torch.zeros(BH, hd, hd, device=q.device)
    n = torch.zeros(BH, hd, device=q.device)
    m = torch.zeros(BH, device=q.device)
    cs, ns, ms = [], [], []
    for c in range(NC):
        cs.append(C), ns.append(n), ms.append(m)
        m1 = torch.maximum(f_end[:, c] + m, a[:, c])
        ws = torch.exp(f_end[:, c] + m - m1)
        wl = torch.exp(a[:, c] - m1)
        C = C * ws[:, None, None] + c_loc[:, c] * wl[:, None, None]
        n = n * ws[:, None] + n_loc[:, c] * wl[:, None]
        m = m1
    C0, n0, m0 = torch.stack(cs, 1), torch.stack(ns, 1), torch.stack(ms, 1)
    # 3. the outputs
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    logd = F[..., :, None] - F[..., None, :] + li[..., None, :]
    logd = torch.where(causal, logd, torch.full_like(logd, neg))
    m_row = torch.maximum(logd.amax(-1), F + m0[..., None]).clamp_min(neg)
    sd = (q @ k.transpose(-1, -2)) * torch.where(
        causal, torch.exp(logd - m_row[..., None]), torch.zeros_like(logd))
    d_state = torch.exp(F + m0[..., None] - m_row)
    num = sd @ v + (q @ C0) * d_state[..., None]
    qn = (q @ n0[..., None])[..., 0] * d_state
    den = torch.maximum((sd.sum(-1) + qn).abs(), torch.exp(-m_row))
    h = (num / den[..., None]).reshape(BH, NC * L, hd)[:, :S]
    return h, (C0, n0, m0)
