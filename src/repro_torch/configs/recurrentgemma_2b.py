"""recurrentgemma-2b — RG-LRU + local attn, 1:2. [arXiv:2402.19427; hf]

26L d_model=2560 10H (MQA, kv=1) head_dim=256 d_ff=7680 vocab=256000.
Block pattern (rec, rec, attn): 18 RG-LRU blocks (lru_width 2560, conv1d
width 4) and 8 local-attention blocks with a 2048-token window, so the
decode state is bounded (a 2048-slot ring buffer per attention layer).
GeLU MLP, untied head, bf16 compute (the ``ModelConfig`` default), fp32
parameters: 3,038,753,280 of them.  A copy of the reference's
``repro/configs/recurrentgemma_2b.py``.
"""
from dataclasses import replace

from repro_torch.config import FAMILY_HYBRID, ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family=FAMILY_HYBRID,
    num_layers=26,  # 26 blocks in (rec, rec, attn) repeating pattern
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,  # MQA in the attention blocks
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_kind="gelu",
    attn_window=2048,
    recurrent=RecurrentConfig(kind="rglru", lru_width=2560, conv1d_width=4,
                              block_pattern=("rec", "rec", "attn")),
    notes="hybrid 1:2 attn:rec; local window 2048 -> long_500k runs",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, name="rg-smoke", num_layers=3, d_model=64, num_heads=2,
        num_kv_heads=1, head_dim=32, d_ff=128, vocab_size=256, attn_window=32,
        recurrent=RecurrentConfig(kind="rglru", lru_width=64, conv1d_width=4,
                                  block_pattern=("rec", "rec", "attn")),
        remat=False)
