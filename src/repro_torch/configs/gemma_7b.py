"""Gemma-7B [arXiv:2403.08295].

28L d_model=3072 16H kv=16 (MHA on 7b; MQA is the 2b variant) d_ff=24576,
head_dim=256, GeGLU, vocab=256000, tied embeddings, embedding scaling.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    ffn_activation="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        head_dim=48,
        ffn_activation="geglu",
        tie_embeddings=True,
    )


register(CONFIG, smoke_config)
