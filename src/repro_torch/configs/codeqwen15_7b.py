"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H kv=32 (MHA) d_ff=13440 vocab=92416; qwen1.5 arch:
attention QKV bias, full attention, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    attn_bias=True,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        attn_bias=True,
        ffn_activation="swiglu",
    )


register(CONFIG, smoke_config)
