"""phi3-mini-3.8b — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
3,821,079,552 parameters.  A copy of the reference's
``repro/configs/phi3_mini_3p8b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family=FAMILY_DENSE,
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    mlp_kind="swiglu",
    notes="pure full attention; long_500k skipped (see DESIGN.md)",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="phi3-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=256, remat=False)
