"""qwen3-8b — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936, head_dim 128.
8,190,735,360 parameters.  A copy of the reference's
``repro/configs/qwen3_8b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family=FAMILY_DENSE,
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    mlp_kind="swiglu",
    rope_theta=1000000.0,
    notes="pure full attention; long_500k skipped (see DESIGN.md)",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="qwen3-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, remat=False)
