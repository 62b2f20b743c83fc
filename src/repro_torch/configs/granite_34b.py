"""granite-34b — llama-arch, code, MQA. [arXiv:2405.04324; hf]

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
33,963,454,464 parameters.  A copy of the reference's
``repro/configs/granite_34b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family=FAMILY_DENSE,
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,  # MQA
    d_ff=24576,
    vocab_size=49152,
    mlp_kind="gelu",  # granite code models use gelu MLPs
    norm_kind="layernorm",
    notes="MQA; deep (88L); FSDP required to fit v5e HBM; long_500k skipped",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="granite-smoke", num_layers=3, d_model=64, num_heads=4,
        num_kv_heads=1, d_ff=128, vocab_size=256, remat=False)
