"""SeamlessM4T-large-v2 (text/unit decoder + speech encoder) [arXiv:2308.11596].

Enc-dec backbone: 24 encoder layers + 24 decoder layers, d_model=1024, 16H
kv=16, d_ff=8192, vocab=256206. The speech frontend (mel filterbank + conformer
feature extractor) is a STUB: input_specs supplies frame embeddings
(B, S_enc, d_model). Decoder has self- and cross-attention.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,           # decoder layers
    num_encoder_layers=24,
    encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    encoder_frontend_dim=1024,
    ffn_activation="gelu",
    attn_bias=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke",
        arch_type="audio",
        num_layers=2,
        num_encoder_layers=2,
        encoder_decoder=True,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        encoder_frontend_dim=128,
        ffn_activation="gelu",
        attn_bias=True,
    )


register(CONFIG, smoke_config)
