"""Run configuration: the subset of the reference's ``ModelConfig`` that
the ported paths read (the dense GQA LM, the attention-free RWKV6 LM and
the RecurrentGemma hybrid), plus ``HermesConfig`` (the gate, the wire,
the allocator and elastic membership) and ``OptimizerConfig``.

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
    is the attention-free RWKV6 LM; ``rglru`` with a pattern such as
    ``("rec", "rec", "attn")`` is the RecurrentGemma hybrid."""

    kind: str  # "rwkv6" | "rglru"
    lru_width: int = 0  # RG-LRU recurrence width (0 = d_model)
    conv1d_width: int = 4  # temporal conv width of the RG-LRU block
    block_pattern: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ModelConfig:
    """A decoder LM: the dense GQA stack (RMSNorm, SwiGLU, RoPE), the
    RWKV6 stack (layernorm, time-mix, channel-mix) or the RecurrentGemma
    hybrid (RG-LRU and local-attention blocks, GeLU MLP).  Parameters are
    fp32 (``param_dtype``); activations run in ``dtype``."""

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
    mlp_kind: str = "swiglu"  # swiglu | gelu | relu_sq (RWKV channel-mix)
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

    @property
    def is_hybrid(self) -> bool:
        return self.recurrent is not None and bool(self.recurrent.block_pattern)

    def layer_is_recurrent(self, layer_idx: int) -> bool:
        """A hybrid layer's kind by the pattern: ``rec`` (RG-LRU) or an
        attention block."""
        pat = self.recurrent.block_pattern
        return pat[layer_idx % len(pat)] == "rec"

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
        n_q, n_kv = self.num_heads * hd, self.num_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d + (2 * hd if self.qk_norm
                                                   else 0)
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * f
        if self.is_hybrid:
            # RG-LRU: w_in_x, w_in_g (d x w), gate_a_w, gate_x_w (w x w),
            # w_out (w x d), conv_w (cw x w) and conv_b, gate_a_b,
            # gate_x_b, lam (w each)
            w = self.recurrent.lru_width or d
            rec = 3 * d * w + 2 * w * w + self.recurrent.conv1d_width * w \
                + 4 * w
            n_rec = sum(self.layer_is_recurrent(i) for i in range(L))
            return (emb + n_rec * rec + (L - n_rec) * attn
                    + L * (mlp + 2 * norm) + norm)
        if self.is_attention_free:
            # time-mix: 5 d x d projections, the mix and decay LoRAs, and
            # 10 vectors of d (mu_x, 5 mu, decay_base, bonus_u, ln_scale,
            # ln_bias); channel-mix: wk, wv, wr and mu_k, mu_r
            time_mix = 5 * d * d + d * 5 * 32 * 2 + 2 * d * 64 + 10 * d
            channel_mix = 2 * d * f + d * d + 2 * d
            per_layer = time_mix + channel_mix + 2 * norm
        else:
            per_layer = attn + mlp + 2 * norm
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
    # the allocator (paper §IV-A): IQR fence factor, mini-batch sizes, and
    # the statistic ("median" | "mean") the dual binary search aims at
    iqr_k: float = 1.5
    mbs_choices: Tuple[int, ...] = (2, 4, 8, 16, 32, 64, 128, 256)
    target: str = "median"
    compression: str = "int4"
    error_feedback: bool = True
    kernel_dispatch: str = "auto"  # auto | on | off
    async_rounds: bool = False
    # elastic membership: a member is declared dead after this many typical
    # iteration times, and a resize keeps at least min_live_pods; a
    # recovered member rejoins only when the speedup over the remaining
    # rounds beats a stall of rejoin_cost_rounds rounds
    failure_timeout_factor: float = 3.0
    min_live_pods: int = 1
    rejoin_cost_rounds: float = 2.0
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
        if self.failure_timeout_factor <= 0.0:
            raise ValueError(
                f"failure_timeout_factor {self.failure_timeout_factor}")
        if self.min_live_pods < 1:
            raise ValueError(f"min_live_pods {self.min_live_pods}")
        if self.rejoin_cost_rounds < 0.0:
            raise ValueError(f"rejoin_cost_rounds {self.rejoin_cost_rounds}")
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
