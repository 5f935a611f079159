"""DeepSeek-V2 236B [arXiv:2405.04434].

60L, d_model=5120, 128 heads (MLA: kv_lora=512, q_lora=1536, rope_hd=64,
nope_hd=128, v_hd=128), d_ff(dense)=12288, MoE: 160 routed experts top-6 +
2 shared, expert hidden 1536, first layer dense, vocab 102400.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,            # dense-layer FFN hidden (first_k_dense layers)
    moe_d_ff=1536,         # per assigned spec: expert hidden 1536
    vocab_size=102400,
    mla=True,
    mla_kv_lora_rank=512,
    mla_q_lora_rank=1536,
    mla_rope_head_dim=64,
    mla_nope_head_dim=128,
    mla_v_head_dim=128,
    moe=True,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_k_dense=1,
    ffn_activation="swiglu",
    rope_theta=10000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        arch_type="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        moe_d_ff=128,
        vocab_size=512,
        mla=True,
        mla_kv_lora_rank=32,
        mla_q_lora_rank=48,
        mla_rope_head_dim=16,
        mla_nope_head_dim=32,
        mla_v_head_dim=32,
        moe=True,
        num_experts=4,
        num_experts_per_tok=2,
        num_shared_experts=1,
        first_k_dense=1,
        ffn_activation="swiglu",
    )


register(CONFIG, smoke_config)
