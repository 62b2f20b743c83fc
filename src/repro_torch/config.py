"""Run configuration: the dense subset of the reference's ``ModelConfig``,
plus ``HermesConfig`` and ``OptimizerConfig``.

A copy, not an import: the port never imports the JAX package.  Field
names and defaults are the reference's (``src/repro/config.py``) so one
set of values configures both sides of a parity test.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.dist.wire import available_formats

FAMILY_DENSE = "dense"


@dataclass(frozen=True)
class ModelConfig:
    """A dense GQA decoder LM (the Level-B presets): RMSNorm, SwiGLU,
    RoPE, fp32 parameters and compute."""

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
    rope_theta: float = 10000.0
    use_rope: bool = True
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def validate(self) -> None:
        if self.family != FAMILY_DENSE:
            raise ValueError(f"{self.name}: only the dense family is ported "
                             f"(got {self.family!r})")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: heads {self.num_heads} not "
                             f"divisible by kv {self.num_kv_heads}")

    def param_count(self) -> int:
        d, L, hd = self.d_model, self.num_layers, self.resolved_head_dim
        n_q, n_kv = self.num_heads * hd, self.num_kv_heads * hd
        per_layer = (d * n_q + 2 * d * n_kv + n_q * d + 3 * d * self.d_ff
                     + 2 * d + (2 * hd if self.qk_norm else 0))
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + L * per_layer + d


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
