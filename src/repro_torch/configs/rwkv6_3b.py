"""rwkv6-3b — Finch, data-dependent decay. [arXiv:2404.05892; hf]

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.  WKV head dim 64
(40 heads).  bf16 compute (the ``ModelConfig`` default), fp32 parameters:
3,099,857,920 of them.  A copy of the reference's
``repro/configs/rwkv6_3b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_SSM, ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family=FAMILY_SSM,
    num_layers=32,
    d_model=2560,
    num_heads=40,  # wkv heads, head_dim 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    use_rope=False,
    mlp_kind="relu_sq",  # rwkv channel-mix uses squared-relu
    norm_kind="layernorm",
    recurrent=RecurrentConfig(kind="rwkv6"),
    notes="attention-free; WKV6 data-dependent decay recurrence",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="rwkv6-smoke", num_layers=2, d_model=64, num_heads=2,
        num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256, remat=False)
