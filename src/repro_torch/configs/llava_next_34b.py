"""llava-next-34b — anyres tiling VLM. [hf:llava-hf/llava-v1.6-34b-hf, text_config; unverified]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000, SwiGLU: the
widths of Yi-34B, llava-v1.6-34b's language model.  (The reference's
file cites ``llava-hf/llava-v1.6-mistral-7b-hf``, the 7B Mistral
variant, whose widths these are not.)  34,388,917,248 parameters.  The
vision frontend is a stub: the model takes pre-computed patch embeddings
(anyres: base 576 tokens + up to 4 tiles -> 2880 image positions),
prepended to the token embeddings.  A copy of the reference's
``repro/configs/llava_next_34b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_VLM, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family=FAMILY_VLM,
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp_kind="swiglu",
    frontend="vision",
    frontend_tokens=2880,  # anyres: 5 tiles x 576 patch embeddings
    notes="vision frontend stubbed (precomputed patch embeddings); "
          "long_500k skipped",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="llava-smoke", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, frontend_tokens=16,
        remat=False)
