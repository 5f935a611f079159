"""xLSTM-125M [arXiv:2405.04517].

12L d_model=768, 4 heads, vocab=50304 (GPT-NeoX rounding). No FFN (d_ff=0):
sLSTM and mLSTM blocks carry their own up/down projections. We use the
paper's 1:1 alternating sLSTM/mLSTM pattern.
"""
from repro_torch.configs.base import ModelConfig, MLSTM, SLSTM, register

_PATTERN = tuple(MLSTM if i % 2 == 0 else SLSTM for i in range(12))

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=_PATTERN,
    ssm_expand=2,
    ssm_num_heads=4,
    tie_embeddings=True,
    ffn_activation="gelu",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke",
        arch_type="ssm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        block_pattern=(MLSTM, SLSTM),
        ssm_expand=2,
        ssm_num_heads=4,
        tie_embeddings=True,
        ffn_activation="gelu",
    )


register(CONFIG, smoke_config)
