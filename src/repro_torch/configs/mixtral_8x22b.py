"""Mixtral-8x22B [arXiv:2401.04088].

56L d_model=6144 48H GQA kv=8 d_ff=16384 vocab=32768, 8 experts top-2, SWA.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    moe_d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    moe=True,
    num_experts=8,
    num_experts_per_tok=2,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        moe_d_ff=256,
        vocab_size=512,
        sliding_window=64,
        moe=True,
        num_experts=4,
        num_experts_per_tok=2,
        ffn_activation="swiglu",
    )


register(CONFIG, smoke_config)
