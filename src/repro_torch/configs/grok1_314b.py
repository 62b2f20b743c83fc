"""grok-1-314b — 8 experts top-2 MoE. [hf:xai-org/grok-1; unverified]

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
316,489,340,928 parameters.  A copy of the reference's
``repro/configs/grok1_314b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_MOE, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family=FAMILY_MOE,
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    mlp_kind="swiglu",  # grok-1 experts are 3-matrix (linear, linear_v, linear_1) GeGLU-style
    moe=MoEConfig(num_experts=8, top_k=2, expert_ff=32768),
    notes="largest assigned arch; FSDP+EP mandatory; long_500k skipped",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="grok1-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256,
        moe=MoEConfig(num_experts=4, top_k=2, expert_ff=128), remat=False)
