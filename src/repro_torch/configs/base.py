"""Unified model/run configuration system.

One :class:`ModelConfig` describes every assigned architecture; per-arch
modules (``repro_torch/configs/<id>.py``) export ``CONFIG`` plus a reduced
``SMOKE_CONFIG`` for CPU tests. Shapes (``train_4k`` etc.) are
:class:`ShapeConfig` instances shared across LM-family archs.

Layer heterogeneity (hybrid/ssm archs) is expressed as a ``block_pattern``
cycled over layers; the model stacks parameters per *super-block* so the
forward pass can ``lax.scan`` over repeats of the pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Mapping

BlockKind = Literal["attn", "local", "rglru", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    shared_expert: bool = False
    capacity_factor: float = 1.25
    group_size: int = 512          # GShard-style routing group
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    block_pattern: tuple[BlockKind, ...] = ("attn",)
    local_window: int = 2048
    moe: MoEConfig | None = None
    # encoder-decoder (audio) / early-fusion (vlm) frontends are STUBS:
    # input_specs() provides precomputed frame/patch embeddings.
    encoder_layers: int = 0
    num_source_positions: int = 0   # encoder frames (audio) / patches (vlm)
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: Literal["swiglu", "gelu"] = "swiglu"
    use_bias: bool = False
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # xlstm-specific
    conv_kernel: int = 4
    # decode KV-cache storage dtype. "float8_e4m3fn" halves the cache —
    # decode is HBM-bound on cache streaming, so this ~doubles decode
    # throughput headroom (scores/math stay bf16/f32; see EXPERIMENTS.md
    # §Perf E). "bfloat16" is the lossless default.
    kv_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        assert self.num_heads % self.num_kv_heads == 0, (
            f"{self.name}: num_heads {self.num_heads} not a multiple of "
            f"kv heads {self.num_kv_heads}")

    # ---- derived ------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_scan_blocks(self) -> int:
        """Super-blocks executed under lax.scan."""
        return self.num_layers // self.pattern_len

    @property
    def n_tail_layers(self) -> int:
        """Remainder layers (unrolled) when L % pattern_len != 0."""
        return self.num_layers - self.n_scan_blocks * self.pattern_len

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding /
        LM-head vocab axis shards evenly over any mesh axis ≤256
        (whisper's 51865 and granite's 49155 are not 16-divisible).
        Pad logits are masked out of the loss and of serving argmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally (long-context capable)."""
        return all(k != "attn" for k in self.block_pattern)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        H, K = self.num_heads, self.num_kv_heads
        per_layer = {}
        attn = d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d
        if self.act == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        norms = 2 * d
        total = 0
        for i in range(self.num_layers):
            kind = self.block_pattern[i % self.pattern_len]
            if kind in ("attn", "local"):
                blk = attn + norms
            elif kind == "rglru":
                # lru: in/out proj (2*d*d) + gates (2*d*d) + conv
                blk = 4 * d * d + self.conv_kernel * d + norms
            elif kind == "mlstm":
                blk = d * (H * hd) * 3 + (H * hd) * d + 3 * H * hd + norms
            elif kind == "slstm":
                blk = 4 * d * d + 4 * d + norms
            else:  # pragma: no cover
                raise ValueError(kind)
            if self.moe is not None and f > 0:
                n_ffn = self.moe.num_experts + int(self.moe.shared_expert)
                blk += n_ffn * mlp + d * self.moe.num_experts  # + router
            elif f > 0:
                blk += mlp
            total += blk
        total += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * norms)
            # decoder cross-attention
            total += self.num_layers * (attn + norms)
        return total

    def num_active_params(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.num_params()
        full = self.num_params()
        f = self.d_ff
        mlp = (3 if self.act == "swiglu" else 2) * self.d_model * f
        inactive = (self.moe.num_experts - self.moe.experts_per_token)
        return full - self.num_layers * inactive * mlp


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The four LM-family shapes assigned to every architecture.
SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.block_pattern
    small = dict(
        num_layers=max(len(pat), 2 if len(pat) == 1 else len(pat)),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, 4 // cfg.q_per_kv) if cfg.q_per_kv <= 4 else 1,
        d_ff=128 if cfg.d_ff > 0 else 0,
        vocab_size=256,
        head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_source_positions=8 if cfg.num_source_positions else 0,
        local_window=16,
        moe=(dataclasses.replace(cfg.moe, num_experts=4,
                                 experts_per_token=min(
                                     cfg.moe.experts_per_token, 2),
                                 group_size=16)
             if cfg.moe else None),
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
