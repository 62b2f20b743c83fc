"""seamless-m4t-large-v2 — enc-dec, multimodal. [arXiv:2308.11596; hf]

24 encoder + 24 decoder layers, d_model=1024 16H (kv=16) d_ff=8192
vocab=256206, GeLU MLPs, layernorm, sinusoidal positions (no RoPE).
1,632,253,952 parameters.  The audio frontend is a stub: the encoder
takes pre-computed frame embeddings.  A copy of the reference's
``repro/configs/seamless_m4t_large_v2.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family=FAMILY_AUDIO,
    num_layers=24,  # decoder layers
    num_encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    mlp_kind="gelu",
    norm_kind="layernorm",
    use_rope=False,  # learned positions in the original; sinusoidal here
    frontend="audio",
    frontend_tokens=0,  # frame embeddings at the input's sequence length
    notes="enc-dec (NOT encoder-only: decode shapes run); audio frontend "
          "stubbed; long_500k skipped",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="seamless-smoke", num_layers=2, num_encoder_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        remat=False)
