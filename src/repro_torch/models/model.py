"""The decoder model: embedding, a flat list of blocks, final norm, LM head.

The port of ``repro/models/model.py`` for the decoder-only families: each
block's mixing sublayer is chosen by ``cfg.block_pattern`` (cycled over
layers) — full attention, sliding-window attention, RG-LRU, mLSTM or
sLSTM — followed by an MLP when ``d_ff > 0``. ``repro`` stacks the
parameters of each repeat of the pattern and scans over them; the port
keeps one module per layer, in order, and loops
(``convert.params_from_jax`` unstacks ``repro``'s parameters into it).
Mixture-of-experts FFNs, the audio encoder and the vision front end are
not ported yet and raise ``NotImplementedError`` (ROADMAP Queue 1 item
5).

Entry points, as in ``repro``:

- :meth:`Model.init_params` draws the weights from a ``torch.Generator``
  with ``repro``'s scales;
- :meth:`Model.forward` is the training forward and the prefill
  (``mode="last_logits", return_kv=True`` is the serving prefill), with
  ``repro``'s ``remat`` options;
- :meth:`Model.init_cache` and :meth:`Model.decode_step` are one token
  against per-layer caches.

A call builds an autograd graph when grad mode is on, as any module's
does: the serving callers (``ServeLoop``, ``launch/serve.py``) run under
``torch.no_grad()``, the training loop (``training/train_loop.py``) does
not.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X

__all__ = ["Block", "Model", "unsupported", "REMAT"]

REMAT = (None, "full", "dots")
# the products "dots" saves: repro's dots_with_no_batch_dims_saveable
# keeps dot_generals without batch dimensions, the products with a weight
# matrix, which reach aten as mm (a 3-D input folds its leading dims)
_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

_ATTN = ("attn", "local")
# the recurrent mixers: parameter specs, forward, state init
_RECURRENT = {
    "rglru": (R.rglru_params, R.rglru_forward, R.rglru_state_init),
    "mlstm": (X.mlstm_params, X.mlstm_forward, X.mlstm_state_init),
    "slstm": (X.slstm_params, X.slstm_forward, X.slstm_state_init),
}


def unsupported(cfg: ModelConfig) -> str | None:
    """Why the port cannot run ``cfg`` yet, or None if it can."""
    missing = sorted({k for k in cfg.block_pattern
                      if k not in _ATTN + tuple(_RECURRENT)})
    if missing:
        return f"{'/'.join(missing)} blocks"
    if cfg.moe is not None:
        return "mixture-of-experts FFNs"
    if cfg.encoder_layers:
        return "the audio encoder and cross attention"
    if cfg.family == "vlm":
        return "the vision front end"
    return None


class Block(nn.Module):
    """One layer: norm, mixing sublayer (attention, RG-LRU, mLSTM or
    sLSTM), residual; then norm, MLP, residual when ``d_ff > 0``."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        norm = {"scale": ((cfg.d_model,), torch.float32, "ones")}
        self.norm1 = L.ParamModule(norm, device)
        self.mix = L.ParamModule(L.attention_params(cfg) if kind in _ATTN
                                 else _RECURRENT[kind][0](cfg), device)
        if cfg.d_ff > 0:
            self.norm2 = L.ParamModule(norm, device)
            self.ffn = L.ParamModule(L.mlp_params(cfg), device)

    def forward(self, x, *, cache=None, decode: bool = False,
                collect_kv: bool = False):
        """Returns (x, cache): the updated cache in decode, the prefill's
        (k, v) of an attention block when ``collect_kv``, else None."""
        cfg = self.cfg
        h = L.rmsnorm(self.norm1, x, cfg.norm_eps)
        new_cache = None
        if self.kind in _ATTN:
            if decode:
                mixed, attn = L.attention_decode(self.mix, h, cache["attn"],
                                                 cfg, kind=self.kind)
                new_cache = dict(cache, attn=attn)
            elif collect_kv:
                mixed, new_cache = L.attention_forward(
                    self.mix, h, cfg, kind=self.kind, return_kv=True)
            else:
                mixed = L.attention_forward(self.mix, h, cfg, kind=self.kind)
        else:
            forward = _RECURRENT[self.kind][1]
            mixed, st = forward(self.mix, h, cfg,
                                cache["rec"] if decode else None)
            if decode:
                new_cache = dict(cache, rec=st)
        x = x + mixed
        if cfg.d_ff > 0:
            x = x + L.mlp_forward(self.ffn, L.rmsnorm(self.norm2, x,
                                                      cfg.norm_eps), cfg)
        return x, new_cache


class Model(L.ParamModule):
    """A decoder over ``cfg``, its parameters allocated on ``device``,
    the card unless the caller names ``"cpu"`` (or ``"meta"``, where they
    take no memory). They are uninitialized: fill them with
    :meth:`init_params` or ``load_state_dict``. Parameter
    names follow ``repro``'s: ``embed``, ``lm_head``, ``final_norm.scale``
    and ``layers.<i>.{norm1,mix,norm2,ffn}.<name>``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        why = unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} are not ported to repro_torch yet "
                f"(ROADMAP Queue 1 item 5)")
        dt = getattr(torch, cfg.param_dtype)
        top = {"embed": ((cfg.padded_vocab, cfg.d_model), dt, 0.02)}
        if not cfg.tie_embeddings:
            top["lm_head"] = ((cfg.d_model, cfg.padded_vocab), dt, 0.02)
        super().__init__(top, device)
        self.cfg = cfg
        self.final_norm = L.ParamModule(
            {"scale": ((cfg.d_model,), torch.float32, "ones")}, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.block_pattern[i % cfg.pattern_len], device)
            for i in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` with ``repro``'s scales:
        ``1/sqrt(fan_in)`` for matrices, 0.02 for the embedding and LM
        head, 0.1 for the conv, 0.01 for the float32 RG-LRU and mLSTM
        gates, 0.05 for the sLSTM's recurrence, ``linspace(2, 6)`` for Λ,
        the mLSTM's gate biases 0 (input) and 3 (forget), ones for the
        norms."""
        for m in self.modules():
            if isinstance(m, L.ParamModule):
                L.ParamModule.init_params(m, generator)
        return self

    def _embed(self, tokens):
        return self.embed[tokens].to(getattr(torch, self.cfg.dtype))

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x.float() @ head.float()

    def forward(self, tokens: torch.Tensor, *, mode: str = "logits",
                return_kv: bool = False, remat: str | None = None):
        """tokens: (B, S) integer -> (output, aux[, kvs]).

        ``mode`` is ``"logits"`` (B, S, V), ``"last_logits"`` (B, 1, V),
        the serving prefill, or ``"hidden"``; logits are float32. ``aux``
        is the MoE load-balancing loss, 0 here. ``kvs`` holds one entry
        per layer: the (k, v) of an attention block, each (B, K, S, hd),
        and None for a recurrent block, whose decode state the serving
        loop builds by teacher-forced steps.

        ``remat``, as in ``repro``, when a graph is built: ``"full"``
        checkpoints each super-block (one repeat of the block pattern)
        and recomputes it in the backward pass; ``"dots"`` does the same
        but saves the products with weight matrices; None saves every
        activation. The remainder layers past the last whole super-block
        are not rematerialized, as in ``repro``. No mode changes a
        number.
        """
        if mode not in ("logits", "last_logits", "hidden"):
            raise ValueError(f"unknown mode {mode!r}")
        if remat not in REMAT:
            raise ValueError(f"unknown remat {remat!r}; one of {REMAT}")
        x = self._embed(tokens)
        kvs = []
        P = self.cfg.pattern_len
        n_scan = self.cfg.n_scan_blocks * P
        for lo in range(0, n_scan, P):
            x, kv = self._superblock(self.layers[lo:lo + P], x, return_kv,
                                     remat)
            kvs += kv
        for layer in self.layers[n_scan:]:
            x, kv = layer(x, collect_kv=return_kv)
            kvs.append(kv)
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        if mode == "hidden":
            out = x
        else:
            out = self._logits(x[:, -1:] if mode == "last_logits" else x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return (out, aux, kvs) if return_kv else (out, aux)

    @staticmethod
    def _superblock(layers, x, collect_kv: bool, remat: str | None):
        def run(x):
            kvs = []
            for layer in layers:
                x, kv = layer(x, collect_kv=collect_kv)
                kvs.append(kv)
            return x, kvs

        if remat is None or not torch.is_grad_enabled():
            return run(x)
        context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _dots_policy) if remat == "dots"
                   else ckpt.noop_context_fn)
        return ckpt.checkpoint(run, x, use_reentrant=False,
                               context_fn=context)

    def init_cache(self, batch: int, max_len: int) -> list[dict]:
        """Per-layer decode caches: a KV ring buffer of ``max_len`` slots
        (``min(max_len, local_window)`` for a local block) in
        ``cfg.kv_dtype``, or a recurrent block's state (the RG-LRU's conv
        tail and h; the mLSTM's C, n, m; the sLSTM's c, n, m, h)."""
        cfg, dev = self.cfg, self.device
        caches = []
        for layer in self.layers:
            if layer.kind in _ATTN:
                size = (min(max_len, cfg.local_window)
                        if layer.kind == "local" else max_len)
                caches.append({"attn": L.attention_cache_init(
                    cfg, batch, size, dtype=getattr(torch, cfg.kv_dtype),
                    device=dev)})
            else:
                init = _RECURRENT[layer.kind][2]
                caches.append({"rec": init(cfg, batch, dev)})
        return caches

    def decode_step(self, tokens: torch.Tensor, caches: list[dict]):
        """One decode step. tokens: (B, 1) -> (logits (B, 1, V) float32,
        new caches). KV caches are updated in place."""
        x = self._embed(tokens)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, c = layer(x, cache=cache, decode=True)
            new.append(c)
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return self._logits(x), new
