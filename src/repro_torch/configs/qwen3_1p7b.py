"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family card].

28L d_model=2048 16H GQA kv=8 d_ff=6144 vocab=151936; qk_norm, tied embeds.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    tie_embeddings=True,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        qk_norm=True,
        tie_embeddings=True,
        ffn_activation="swiglu",
    )


register(CONFIG, smoke_config)
