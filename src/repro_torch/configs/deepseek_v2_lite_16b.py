"""deepseek-v2-lite-16b — MLA kv_lora=512, 2 shared + 64 routed top-6. [arXiv:2405.04434; hf]

27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6.
MLA: kv_lora_rank 512, decoupled rope head dim 64, nope head dim 128.
16,210,324,992 parameters.  A copy of the reference's
``repro/configs/deepseek_v2_lite_16b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_MOE, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family=FAMILY_MOE,
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MLA: kv heads == q heads after latent up-projection
    head_dim=128,  # nope head dim
    d_ff=1408,  # per-expert intermediate
    vocab_size=102400,
    mlp_kind="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                  num_shared_experts=2, shared_ff=1408),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, v_head_dim=128),
    notes="MLA compresses the KV cache 512-dim latent; attention still quadratic -> long_500k skipped",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="dsv2-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=32, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=32,
                      num_shared_experts=1, shared_ff=32),
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=8, v_head_dim=16),
        remat=False)
