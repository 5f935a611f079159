"""The paper's own large-scale model: ViT-Base/16 (86M) fine-tuned with LoRA
rank 8 on the QKV projection (Appendix III-C, Table 10).

Represented in the zoo as a dense decoder-free encoder config; the actual
vision models used by the FL experiments live in repro.models.vision.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="paper-vit-b16",
    arch_type="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=1000,     # classification head width upper bound
    ffn_activation="gelu",
    attn_bias=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paper-vit-b16-smoke",
        arch_type="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=100,
        ffn_activation="gelu",
        attn_bias=True,
    )


register(CONFIG, smoke_config)
