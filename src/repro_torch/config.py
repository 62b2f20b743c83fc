"""Run configuration: the subset of the reference's ``ModelConfig`` that
the ported paths read (the dense GQA LM and the attention-free RWKV6 LM),
plus ``HermesConfig`` and ``OptimizerConfig``.

A copy, not an import: the port never imports the JAX package.  Field
names and defaults are the reference's (``src/repro/config.py``) so one
set of values configures both sides of a parity test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.dist.wire import available_formats

FAMILY_DENSE = "dense"
FAMILY_MOE = "moe"
FAMILY_SSM = "ssm"
FAMILY_HYBRID = "hybrid"
FAMILY_VLM = "vlm"
FAMILY_AUDIO = "audio"
VALID_FAMILIES = (FAMILY_DENSE, FAMILY_MOE, FAMILY_SSM, FAMILY_HYBRID,
                  FAMILY_VLM, FAMILY_AUDIO)


@dataclass(frozen=True)
class RecurrentConfig:
    """Linear-recurrence blocks: ``rwkv6`` with an empty ``block_pattern``
    is the attention-free RWKV6 LM; ``rglru`` and a non-empty pattern (the
    RecurrentGemma hybrid) are not ported yet."""

    kind: str  # "rwkv6" | "rglru"
    block_pattern: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ModelConfig:
    """A decoder LM: the dense GQA stack (RMSNorm, SwiGLU, RoPE) or the
    RWKV6 stack (layernorm, time-mix, channel-mix).  Parameters are fp32
    (``param_dtype``); activations run in ``dtype``."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    qk_norm: bool = False
    attn_window: int = 0  # 0 = global attention; >0 = sliding window
    rope_theta: float = 10000.0
    use_rope: bool = True
    mlp_kind: str = "swiglu"  # swiglu | relu_sq (RWKV channel-mix)
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    recurrent: Optional[RecurrentConfig] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.recurrent is not None and not self.recurrent.block_pattern

    def validate(self) -> None:
        if self.family not in VALID_FAMILIES:
            raise ValueError(f"{self.name}: family {self.family!r}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: heads {self.num_heads} not "
                             f"divisible by kv {self.num_kv_heads}")
        if self.recurrent is not None and \
                self.recurrent.kind not in ("rwkv6", "rglru"):
            raise ValueError(f"{self.name}: recurrent kind "
                             f"{self.recurrent.kind!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"{self.name}: dtype {self.dtype!r}")
        if self.param_dtype != "float32":
            raise ValueError(f"{self.name}: parameters are fp32 in the port "
                             f"(got {self.param_dtype!r})")

    def param_count(self) -> int:
        """The exact parameter count of the port's (and the reference's)
        tree; the reference's own ``param_count`` approximates RWKV6."""
        d, L, hd, f = self.d_model, self.num_layers, self.resolved_head_dim, \
            self.d_ff
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        norm = 2 * d if self.norm_kind == "layernorm" else d
        if self.is_attention_free:
            # time-mix: 5 d x d projections, the mix and decay LoRAs, and
            # 10 vectors of d (mu_x, 5 mu, decay_base, bonus_u, ln_scale,
            # ln_bias); channel-mix: wk, wv, wr and mu_k, mu_r
            time_mix = 5 * d * d + d * 5 * 32 * 2 + 2 * d * 64 + 10 * d
            channel_mix = 2 * d * f + d * d + 2 * d
            per_layer = time_mix + channel_mix + 2 * norm
        else:
            n_q, n_kv = self.num_heads * hd, self.num_kv_heads * hd
            per_layer = (d * n_q + 2 * d * n_kv + n_q * d + 3 * d * f
                         + 2 * norm + (2 * hd if self.qk_norm else 0))
        return emb + L * per_layer + norm


@dataclass(frozen=True)
class HermesConfig:
    """Hyper-parameters of the paper (Table I + §IV); the reference's
    defaults.  ``kernel_dispatch``: ``"auto"`` runs the CUDA kernels when
    the tensors are on a card, ``"on"``/``"off"`` force the fused-kernel or
    the plain merge association."""

    alpha: float = -1.3
    beta: float = 0.1
    lam: int = 5
    window: int = 10
    eta: float = 0.1
    alpha_min: float = -3.0
    alpha_max: float = 0.0
    compression: str = "int4"
    error_feedback: bool = True
    kernel_dispatch: str = "auto"  # auto | on | off
    async_rounds: bool = False
    participation_rate: float = 1.0
    admission: str = "topk"
    n_clusters: int = 1

    def validate(self) -> None:
        if self.compression not in available_formats():
            raise ValueError(f"compression {self.compression!r} not "
                             f"registered (want one of {available_formats()})")
        if self.kernel_dispatch not in ("auto", "on", "off"):
            raise ValueError(f"kernel_dispatch {self.kernel_dispatch!r}")
        if self.window < 1 or self.lam < 1:
            raise ValueError("window and lam must be >= 1")
        if not 0.0 < self.participation_rate <= 1.0:
            raise ValueError(f"participation_rate {self.participation_rate}")
        if self.admission not in ("topk", "prob"):
            raise ValueError(f"admission {self.admission!r}")
        if self.n_clusters < 1:
            raise ValueError(f"n_clusters {self.n_clusters}")


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sgd"  # sgd | adamw
    lr: float = 0.1
    momentum: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
