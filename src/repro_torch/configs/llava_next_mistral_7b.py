"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone: 32L d_model=4096 32H GQA kv=8 d_ff=14336 vocab=32000, SWA 4096.
Vision frontend (SigLIP/CLIP + anyres tiling) is a STUB: input_specs supplies
pre-projected patch embeddings (B, num_image_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    ffn_activation="swiglu",
    rope_theta=1000000.0,
    vision_frontend=True,
    num_image_tokens=1152,   # anyres 2x2 tiles + base thumb, pooled stub
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke",
        arch_type="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        sliding_window=64,
        ffn_activation="swiglu",
        vision_frontend=True,
        num_image_tokens=16,
    )


register(CONFIG, smoke_config)
