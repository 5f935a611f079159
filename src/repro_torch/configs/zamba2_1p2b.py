"""Zamba2-1.2B [arXiv:2411.15242].

38L d_model=2048, Mamba2 backbone (ssm_state=64) with a SHARED-parameter
attention(+MLP) block interleaved every 6 Mamba2 blocks (32H kv=32,
d_ff=8192 inside the shared block). vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, MAMBA2, SHARED_ATTN, register


def _pattern(n: int, every: int):
    kinds = []
    for i in range(n):
        kinds.append(SHARED_ATTN if (i + 1) % every == 0 else MAMBA2)
    return tuple(kinds)


CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=_pattern(38, 6),
    ssm_state_size=64,
    ssm_num_heads=32,
    ssm_expand=2,
    shared_attn_every=6,
    ffn_activation="geglu",
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke",
        arch_type="hybrid",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        block_pattern=(MAMBA2, MAMBA2, SHARED_ATTN),
        ssm_state_size=16,
        ssm_num_heads=4,
        ssm_expand=2,
        shared_attn_every=3,
        ffn_activation="geglu",
        tie_embeddings=True,
    )


register(CONFIG, smoke_config)
