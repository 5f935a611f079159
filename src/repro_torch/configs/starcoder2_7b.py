"""StarCoder2-7B [arXiv:2402.19173].

32L d_model=4608 36H GQA kv=4 d_ff=18432 vocab=49152; RoPE, sliding-window
4096, attention bias, gelu FFN (starcoder2 uses non-gated MLP with bias).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    sliding_window=4096,
    attn_bias=True,
    ffn_activation="gelu",
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=144,
        num_heads=6,   # head_dim 24; kv=2 divides 6
        num_kv_heads=2,
        d_ff=288,
        vocab_size=512,
        sliding_window=64,
        attn_bias=True,
        ffn_activation="gelu",
    )


register(CONFIG, smoke_config)
