"""Config system, copied from ``repro/configs/base.py``: one dataclass
describes every architecture of the JAX package's zoo.

Each ported architecture gets a module ``repro_torch/configs/<id>.py`` that
exports ``CONFIG`` (the exact published shape) and ``smoke_config()`` (a
reduced same-family variant used by CPU tests).  Every architecture of
the JAX zoo is ported: ``qwen3-1.7b``, ``zamba2-1.2b``, ``xlstm-125m``,
the dense ``codeqwen1.5-7b``, ``starcoder2-7b``, ``gemma-7b`` and
``paper-vit-b16``, the MoE ``mixtral-8x22b``, MLA with MoE
``deepseek-v2-236b``, the encoder-decoder ``seamless-m4t-large-v2`` and
the VLM backbone ``llava-next-mistral-7b``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds understood by repro_torch.models.transformer
ATTN = "attn"            # (GQA / MLA) attention block
MAMBA2 = "mamba2"        # Mamba2 SSM block
SLSTM = "slstm"          # xLSTM sLSTM block
MLSTM = "mlstm"          # xLSTM mLSTM block
SHARED_ATTN = "shared_attn"  # zamba2-style shared-parameter attention block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    # --- attention variants ---
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: Optional[int] = None   # None = full attention
    # MLA (deepseek-v2)
    mla: bool = False
    mla_kv_lora_rank: int = 512
    mla_q_lora_rank: int = 1536
    mla_rope_head_dim: int = 64
    mla_nope_head_dim: int = 128
    mla_v_head_dim: int = 128
    # --- ffn variants ---
    ffn_activation: str = "swiglu"   # swiglu | geglu | gelu
    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # expert hidden size (if != d_ff)
    first_k_dense: int = 0           # deepseek: first k layers use dense FFN
    router_aux_loss_coef: float = 0.001
    moe_capacity_factor: float = 2.0  # expert-parallel slack (§Perf B3)
    # --- SSM / xLSTM / hybrid ---
    block_pattern: Optional[Tuple[str, ...]] = None  # per-layer kinds; None -> all ATTN
    ssm_state_size: int = 64
    ssm_num_heads: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    shared_attn_every: int = 0       # zamba2: shared attn block every k mamba blocks
    # --- enc-dec (audio) ---
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_frontend_dim: int = 0    # stub frame-embedding dim (== d_model)
    # --- VLM ---
    vision_frontend: bool = False
    num_image_tokens: int = 0        # anyres stub patch count for train shapes
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.num_layers
            return self.block_pattern
        return tuple([ATTN] * self.num_layers)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        enc_layers = self.num_encoder_layers if self.encoder_decoder else 0
        for kind in list(self.layer_kinds()) + [ATTN] * enc_layers:
            if kind in (ATTN, SHARED_ATTN):
                if self.mla:
                    qh = self.mla_nope_head_dim + self.mla_rope_head_dim
                    total += d * self.mla_q_lora_rank + self.mla_q_lora_rank * nq * qh
                    total += d * (self.mla_kv_lora_rank + self.mla_rope_head_dim)
                    total += self.mla_kv_lora_rank * nq * (self.mla_nope_head_dim + self.mla_v_head_dim)
                    total += nq * self.mla_v_head_dim * d
                else:
                    total += d * nq * hd + 2 * d * nkv * hd + nq * hd * d
                total += self._ffn_params()
            elif kind == MAMBA2:
                d_in = self.ssm_expand * d
                total += d * (2 * d_in + 2 * self.ssm_state_size *
                              max(self.ssm_num_heads, 1)) + d_in * d
            elif kind in (SLSTM, MLSTM):
                d_in = self.ssm_expand * d
                total += 4 * d * d_in + d_in * d
        # cross attention for decoder layers
        if self.encoder_decoder:
            total += self.num_layers * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
        return total

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.moe:
            eff = self.moe_d_ff or self.d_ff
            n_mats = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
            routed = self.num_experts * n_mats * d * eff
            shared = self.num_shared_experts * n_mats * d * eff
            return routed + shared + d * self.num_experts
        n_mats = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        return n_mats * d * self.d_ff

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-active experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        eff = self.moe_d_ff or self.d_ff
        n_mats = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        n_moe_layers = sum(1 for k in self.layer_kinds() if k == ATTN) - self.first_k_dense
        inactive = n_moe_layers * (self.num_experts - self.num_experts_per_tok) * n_mats * d * eff
        return self.param_count() - inactive


_REGISTRY: dict = {}


def register(config: ModelConfig, smoke_fn) -> None:
    _REGISTRY[config.name] = (config, smoke_fn)


def _lookup(name: str):
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_config(name: str) -> ModelConfig:
    return _lookup(name)[0]


def get_smoke_config(name: str) -> ModelConfig:
    return _lookup(name)[1]()


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ("deepseek_v2_236b", "llava_next_mistral_7b", "starcoder2_7b",
                "mixtral_8x22b", "xlstm_125m", "qwen3_1p7b", "codeqwen15_7b",
                "zamba2_1p2b", "gemma_7b", "seamless_m4t_large_v2",
                "paper_vit"):
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
