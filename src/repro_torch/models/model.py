"""The model: embedding, a flat list of blocks, final norm, LM head.

The port of ``repro/models/model.py``, for all ten configurations of
``configs.ARCHS``: each block's mixing sublayer is chosen by
``cfg.block_pattern`` (cycled over layers) — full attention,
sliding-window attention, RG-LRU, mLSTM or sLSTM — followed by an FFN
when ``d_ff > 0``: an MLP, or a mixture of experts (``models/moe.py``)
when ``cfg.moe`` is set. ``repro`` stacks the parameters of each repeat
of the pattern and scans over them; the port keeps one module per layer,
in order, and loops (``convert.params_from_jax`` unstacks ``repro``'s
parameters into it).

The front ends are ``repro``'s stubs. Audio (whisper,
``cfg.encoder_layers``): a bidirectional encoder over precomputed frame
embeddings (``audio_embeds``), and per block a cross-attention sublayer
to its output. Vision (``family == "vlm"``): early fusion, the given
patch embeddings (``vision_embeds``) written over the first positions.
In decode, cross attention reads the K/V that ``init_cache(enc_out=)``
placed in the cache: zeros, as in ``repro``, which fills them nowhere
(ROADMAP Queue 3, R10), so a decode step's cross sublayer adds 0.

Entry points, as in ``repro``:

- :meth:`Model.init_params` draws the weights from a ``torch.Generator``
  with ``repro``'s scales;
- :meth:`Model.forward` is the training forward and the prefill
  (``mode="last_logits", return_kv=True`` is the serving prefill), with
  ``repro``'s ``remat`` options; it returns the MoE load-balancing loss
  summed over the layers;
- :meth:`Model.encode` is the audio encoder alone;
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
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import xlstm as X

__all__ = ["Block", "EncoderLayer", "Model", "unsupported", "REMAT"]

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


def _norm(cfg: ModelConfig, device) -> L.ParamModule:
    return L.ParamModule({"scale": ((cfg.d_model,), torch.float32, "ones")},
                         device)


def unsupported(cfg: ModelConfig) -> str | None:
    """The block kinds of ``cfg`` that the model has no mixer for, or
    None (every config of ``configs.ARCHS``)."""
    missing = sorted({k for k in cfg.block_pattern
                      if k not in _ATTN + tuple(_RECURRENT)})
    return f"{'/'.join(missing)} blocks" if missing else None


class Block(nn.Module):
    """One layer: norm, mixing sublayer (attention, RG-LRU, mLSTM or
    sLSTM), residual; with an encoder (whisper), norm, cross attention to
    the encoder's output, residual; then norm, FFN (an MLP or a mixture
    of experts), residual when ``d_ff > 0``."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm1 = _norm(cfg, device)
        self.mix = L.ParamModule(L.attention_params(cfg) if kind in _ATTN
                                 else _RECURRENT[kind][0](cfg), device)
        if cfg.encoder_layers:
            self.norm_x = _norm(cfg, device)
            self.cross = L.ParamModule(L.attention_params(cfg), device)
        if cfg.d_ff > 0:
            self.norm2 = _norm(cfg, device)
            self.ffn = (M.MoE(cfg, device) if cfg.moe is not None
                        else L.ParamModule(L.mlp_params(cfg), device))

    def forward(self, x, *, enc_out=None, cache=None, decode: bool = False,
                collect_kv: bool = False):
        """Returns (x, cache, aux): the updated cache in decode, the
        prefill's (k, v) of an attention block when ``collect_kv``, else
        None; ``aux`` the MoE layer's load-balancing loss (float32), or
        None without experts."""
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
        if cfg.encoder_layers:
            h = L.rmsnorm(self.norm_x, x, cfg.norm_eps)
            if decode:
                x = x + _cross_decode(self.cross, h, cache["cross"], cfg)
            else:
                x = x + L.attention_forward(self.cross, h, cfg, kind="cross",
                                            encoder_out=enc_out)
        aux = None
        if cfg.d_ff > 0:
            h = L.rmsnorm(self.norm2, x, cfg.norm_eps)
            if cfg.moe is not None:
                f, aux = M.moe_forward(self.ffn, h, cfg)
            else:
                f = L.mlp_forward(self.ffn, h, cfg)
            x = x + f
        return x, new_cache, aux


def _cross_decode(p, x, kv, cfg: ModelConfig):
    """Decode-time cross attention against the cached encoder K/V, as
    ``repro``'s ``_cross_decode``: no bias on q or on the output."""
    B = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    q = L.mm(x, p["wq"]).reshape(B, 1, H, hd).transpose(1, 2)
    out = L.full_attention(q, kv["k"], kv["v"], causal=False)
    return L.mm(out.transpose(1, 2).reshape(B, 1, H * hd), p["wo"])


class EncoderLayer(nn.Module):
    """One bidirectional encoder layer (whisper): norm, self attention
    without RoPE or mask, residual; norm, MLP, residual."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = _norm(cfg, device)
        self.attn = L.ParamModule(L.attention_params(cfg), device)
        self.norm2 = _norm(cfg, device)
        self.ffn = L.ParamModule(L.mlp_params(cfg), device)

    def forward(self, x, cfg: ModelConfig):
        h = L.rmsnorm(self.norm1, x, cfg.norm_eps)
        x = x + L.attention_forward(self.attn, h, cfg, kind="cross",
                                    encoder_out=h)
        h = L.rmsnorm(self.norm2, x, cfg.norm_eps)
        return x + L.mlp_forward(self.ffn, h, cfg)


class Model(L.ParamModule):
    """A model over ``cfg``, its parameters allocated on ``device``, the
    card unless the caller names ``"cpu"`` (or ``"meta"``, where they
    take no memory). They are uninitialized: fill them with
    :meth:`init_params` or ``load_state_dict``. Parameter names follow
    ``repro``'s: ``embed``, ``lm_head``, ``final_norm.scale``,
    ``layers.<i>.{norm1,mix,norm_x,cross,norm2,ffn}.<name>`` (a MoE's
    ``ffn.router``, ``ffn.experts.<name>``, ``ffn.shared.<name>``) and
    ``encoder.layers.<i>.{norm1,attn,norm2,ffn}.<name>``,
    ``encoder.final_norm.scale``."""

    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        why = unsupported(cfg)
        if why is not None:
            raise ValueError(f"{cfg.name}: the model has no mixer for {why}")
        dt = getattr(torch, cfg.param_dtype)
        top = {"embed": ((cfg.padded_vocab, cfg.d_model), dt, 0.02)}
        if not cfg.tie_embeddings:
            top["lm_head"] = ((cfg.d_model, cfg.padded_vocab), dt, 0.02)
        super().__init__(top, device)
        self.cfg = cfg
        self.final_norm = _norm(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.block_pattern[i % cfg.pattern_len], device)
            for i in range(cfg.num_layers))
        if cfg.encoder_layers:
            self.encoder = nn.Module()
            self.encoder.layers = nn.ModuleList(
                EncoderLayer(cfg, device) for _ in range(cfg.encoder_layers))
            self.encoder.final_norm = _norm(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` with ``repro``'s scales:
        ``1/sqrt(fan_in)`` for matrices (an expert's over d or f, not E),
        0.02 for the embedding, the LM head and the router, 0.1 for the
        conv, 0.01 for the float32 RG-LRU and mLSTM gates, 0.05 for the
        sLSTM's recurrence, ``linspace(2, 6)`` for Λ, the mLSTM's gate
        biases 0 (input) and 3 (forget), zeros for the attention biases,
        ones for the norms."""
        for m in self.modules():
            if isinstance(m, L.ParamModule):
                L.ParamModule.init_params(m, generator)
        return self

    def _embed(self, tokens):
        return self.embed[tokens].to(getattr(torch, self.cfg.dtype))

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return x.float() @ head.float()

    def encode(self, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The audio encoder: (B, Senc, d) frame embeddings -> (B, Senc,
        d), through ``cfg.encoder_layers`` layers and a final norm."""
        x = audio_embeds
        for layer in self.encoder.layers:
            x = layer(x, self.cfg)
        return L.rmsnorm(self.encoder.final_norm, x, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, *, vision_embeds=None,
                audio_embeds=None, mode: str = "logits",
                return_kv: bool = False, remat: str | None = None):
        """tokens: (B, S) integer -> (output, aux[, kvs]).

        ``vision_embeds`` (B, P, d) replace the embeddings of the first P
        positions (early fusion); ``audio_embeds`` (B, Senc, d) are
        encoded, and every block attends to the encoding (a config with
        an encoder requires them). ``mode`` is ``"logits"`` (B, S, V),
        ``"last_logits"`` (B, 1, V), the serving prefill, or
        ``"hidden"``; logits are float32. ``aux`` is the MoE
        load-balancing loss summed over the layers (0 without experts),
        float32. ``kvs`` holds one entry per layer: the (k, v) of an
        attention block, each (B, K, S, hd), and None for a recurrent
        block, whose decode state the serving loop builds by
        teacher-forced steps.

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
        if vision_embeds is not None:           # VLM early fusion
            n_patch = vision_embeds.shape[1]
            x = torch.cat([vision_embeds.to(x.dtype), x[:, n_patch:]], dim=1)
        enc_out = None
        if self.cfg.encoder_layers:
            if audio_embeds is None:
                raise ValueError(f"{self.cfg.name} encodes audio: pass "
                                 f"audio_embeds")
            enc_out = self.encode(audio_embeds)
        kvs, auxs = [], []
        P = self.cfg.pattern_len
        n_scan = self.cfg.n_scan_blocks * P
        for lo in range(0, n_scan, P):
            x, kv, aux = self._superblock(self.layers[lo:lo + P], x, enc_out,
                                          return_kv, remat)
            kvs += kv
            if aux is not None:
                auxs.append(aux)
        # repro's order: the super-blocks' sum, then each tail layer's
        aux = torch.stack(auxs).sum() if auxs else torch.zeros(
            (), dtype=torch.float32, device=x.device)
        for layer in self.layers[n_scan:]:
            x, kv, a = layer(x, enc_out=enc_out, collect_kv=return_kv)
            kvs.append(kv)
            aux = aux if a is None else aux + a
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        if mode == "hidden":
            out = x
        else:
            out = self._logits(x[:, -1:] if mode == "last_logits" else x)
        return (out, aux, kvs) if return_kv else (out, aux)

    @staticmethod
    def _superblock(layers, x, enc_out, collect_kv: bool,
                    remat: str | None):
        def run(x, enc_out):
            kvs, aux = [], None
            for layer in layers:
                x, kv, a = layer(x, enc_out=enc_out, collect_kv=collect_kv)
                kvs.append(kv)
                if a is not None:
                    aux = a if aux is None else aux + a
            return x, kvs, aux

        if remat is None or not torch.is_grad_enabled():
            return run(x, enc_out)
        context = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                     _dots_policy) if remat == "dots"
                   else ckpt.noop_context_fn)
        return ckpt.checkpoint(run, x, enc_out, use_reentrant=False,
                               context_fn=context)

    def init_cache(self, batch: int, max_len: int,
                   enc_out: torch.Tensor | None = None) -> list[dict]:
        """Per-layer decode caches: a KV ring buffer of ``max_len`` slots
        (``min(max_len, local_window)`` for a local block) in
        ``cfg.kv_dtype``, or a recurrent block's state (the RG-LRU's conv
        tail and h; the mLSTM's C, n, m; the sLSTM's c, n, m, h). With an
        encoder and ``enc_out`` (B, Senc, d), each layer also gets the
        cross K/V, (B, K, Senc, hd) bfloat16 zeros, as ``repro``'s
        placeholder (R10)."""
        cfg, dev = self.cfg, self.device
        caches = []
        for layer in self.layers:
            if layer.kind in _ATTN:
                size = (min(max_len, cfg.local_window)
                        if layer.kind == "local" else max_len)
                c = {"attn": L.attention_cache_init(
                    cfg, batch, size, dtype=getattr(torch, cfg.kv_dtype),
                    device=dev)}
            else:
                c = {"rec": _RECURRENT[layer.kind][2](cfg, batch, dev)}
            if cfg.encoder_layers and enc_out is not None:
                shape = (batch, cfg.num_kv_heads, enc_out.shape[1],
                         cfg.head_dim)
                c["cross"] = {
                    "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                    "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev)}
            caches.append(c)
        return caches

    def decode_step(self, tokens: torch.Tensor, caches: list[dict]):
        """One decode step. tokens: (B, 1) -> (logits (B, 1, V) float32,
        new caches). KV caches are updated in place."""
        x = self._embed(tokens)
        new = []
        for layer, cache in zip(self.layers, caches):
            x, c, _ = layer(x, cache=cache, decode=True)
            new.append(c)
        x = L.rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return self._logits(x), new
