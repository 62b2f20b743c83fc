"""yi-6b — llama-arch GQA. [arXiv:2403.04652; hf]

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
6,061,035,520 parameters.  A copy of the reference's
``repro/configs/yi_6b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family=FAMILY_DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    mlp_kind="swiglu",
    rope_theta=5000000.0,
    notes="pure full attention; long_500k skipped (see DESIGN.md)",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="yi-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, remat=False)
