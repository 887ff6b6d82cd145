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
"""
from __future__ import annotations

import math

import torch

__all__ = ["mlstm_ref"]


def mlstm_ref(q, k, v, log_i, log_f):
    """q, k, v: (BH, S, hd); log_i, log_f: (BH, S). Returns h (BH, S, hd)
    in float32."""
    BH, S, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    q = q.float() * scale
    k, v = k.float(), v.float()
    log_i, log_f = log_i.float(), log_f.float()
    C = torch.zeros(BH, hd, hd, dtype=torch.float32, device=q.device)
    n = torch.zeros(BH, hd, dtype=torch.float32, device=q.device)
    m = torch.zeros(BH, dtype=torch.float32, device=q.device)
    out = torch.empty(BH, S, hd, dtype=torch.float32, device=q.device)
    for t in range(S):
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
        out[:, t] = num / den[:, None]
        m = m_new
    return out
