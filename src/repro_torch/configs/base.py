"""Config schema of the port: a copy of the reference's
``configs/base.py`` (the model dataclasses and the arch registry).

One schema covers every architecture family (dense / MoE / SSM / hybrid /
enc-dec / VLM backbones); the port grows family by family and each arch
module comes with its slice.  Configs are plain frozen dataclasses.

Dimension padding: ``resolve()`` pads attention heads up to a multiple of
the tensor-parallel degree and the vocabulary up to a multiple of 256.
Padded vocab rows are masked out of the logits; padded heads are
zero-initialised so their o-projection contribution is exactly zero.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 128
    top_k: int = 8
    capacity_factor: float = 1.25
    # d_ff of each expert lives in ModelConfig.d_ff
    router_aux_weight: float = 0.001
    num_groups: int = 0          # 0 -> resolved to the number of dp shards


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: Tuple[float, float] = (1.0, 16.0)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_channels(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.n_groups * self.d_state


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style shared attention block over a Mamba2 backbone."""
    shared_every: int = 6          # apply the shared block after every N mamba layers
    shared_num_heads: int = 32
    shared_kv_heads: int = 32
    shared_d_ff: int = 10240
    lora_rank: int = 8             # per-invocation LoRA deltas on the shared block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention options ---
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    mrope: bool = False            # Qwen2-VL 3-axis M-RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    # --- optional sub-configs ---
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- enc-dec ---
    enc_layers: int = 0            # encdec: num_layers == decoder layers
    # --- embeddings ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # --- numerics / perf knobs ---
    dtype: str = "bfloat16"
    attn_q_chunk: int = 1024       # reference's blockwise q tile (unused here)
    attn_kv_chunk: int = 1024      # reference's blockwise kv tile (unused here)
    loss_chunk: int = 512          # chunked cross-entropy seq tile
    remat: str = "full"            # none | full | dots
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV (+ scales)
    scan_layers: bool = True
    use_pallas: bool = False       # reference only: the port's kernels run
                                   # on every CUDA tensor
    # --- padding (filled by resolve()) ---
    padded_heads: int = 0
    padded_vocab: int = 0
    # --- vlm/audio frontend stubs ---
    num_frontend_tokens: int = 0   # vision patches / audio frames provided by input_specs

    # ------------------------------------------------------------------
    def resolve(self, tp: int, dp: int = 1) -> "ModelConfig":
        """Fill padded dims for a given tensor-parallel degree, and the MoE
        dispatch-group count for a given data-parallel degree."""
        ph = self.num_heads
        if self.family not in ("ssm",):
            ph = int(math.ceil(self.num_heads / tp) * tp)
        pv = int(math.ceil(self.vocab_size / VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE)
        # vocab shards must divide evenly too
        while pv % tp != 0:
            pv += VOCAB_PAD_MULTIPLE
        cfg = dataclasses.replace(self, padded_heads=ph, padded_vocab=pv)
        if cfg.moe is not None and cfg.moe.num_groups == 0:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, num_groups=dp))
        return cfg

    # --- derived sizes -------------------------------------------------
    @property
    def padded_kv(self) -> int:
        """MHA (kv == heads) must pad kv alongside q heads."""
        if self.padded_heads and self.num_kv_heads == self.num_heads:
            return self.padded_heads
        return self.num_kv_heads

    @property
    def q_dim(self) -> int:
        return self.padded_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (unpadded dims; used for MODEL_FLOPS)."""
        d, h, kv, hd, ff, V, L = (self.d_model, self.num_heads, self.num_kv_heads,
                                  self.head_dim, self.d_ff, self.vocab_size,
                                  self.num_layers)
        n = 0
        if self.family == "encdec":
            # encoder
            enc_attn = d * h * hd * 2 + d * kv * hd * 2
            enc = self.enc_layers * (enc_attn + 2 * d * ff + 2 * d)
            dec_attn = 2 * (d * h * hd * 2 + d * kv * hd * 2)
            dec = L * (dec_attn + 2 * d * ff + 3 * d)
            n = enc + dec + 2 * V * d
            return n
        for _ in range(1):
            if self.family in ("ssm",):
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                per = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                       + s.d_conv * s.conv_channels(d) + nh * 2 + di * d + d)
                n += L * per
            elif self.family == "hybrid":
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                per = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                       + s.d_conv * s.conv_channels(d) + nh * 2 + di * d + d)
                n += L * per
                hb = self.hybrid
                d2 = 2 * d
                shared = (d2 * hb.shared_num_heads * hd + d2 * hb.shared_kv_heads * hd * 2
                          + hb.shared_num_heads * hd * d + 2 * d2 * hb.shared_d_ff)
                n_invocations = L // hb.shared_every
                lora = n_invocations * hb.lora_rank * (d2 * 2) * 3
                n += shared + lora
            else:
                if self.mla is not None:
                    m = self.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    attn = (d * m.q_lora_rank + m.q_lora_rank * h * qk
                            + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                            + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                            + h * m.v_head_dim * d)
                else:
                    attn = d * h * hd + d * kv * hd * 2 + h * hd * d
                if self.moe is not None:
                    e = self.moe.top_k if active_only else self.moe.num_experts
                    mlp = e * 3 * d * ff + d * self.moe.num_experts
                else:
                    mlp = 3 * d * ff
                n += L * (attn + mlp + 2 * d)
        n += V * d * (1 if self.tie_embeddings else 2)
        return n


# ----------------------------------------------------------------------
_REGISTRY = {}


def _norm(name: str) -> str:
    return name.replace("_", "-").replace(".", "-").lower()


def register(cfg_fn):
    _REGISTRY[_norm(cfg_fn.__name__)] = cfg_fn
    return cfg_fn


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    from repro_torch.configs import archs  # noqa: F401
    key = _norm(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key](smoke=smoke)

