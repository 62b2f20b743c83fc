"""Run configuration: the reference's ``ModelConfig`` for the ported paths
(the dense stacks, MoE and MLA, the attention-free RWKV6 LM, the
RecurrentGemma hybrid, the encoder-decoder and the vision frontend),
``ShapeConfig`` and the part of
``ParallelConfig`` that the step builders read, plus ``HermesConfig``
(the gate, the wire, the allocator and elastic membership) and
``OptimizerConfig``.

A copy, not an import: the port never imports the JAX package.  Field
names and defaults are the reference's (``src/repro/config.py``) so one
set of values configures both sides of a parity test.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
class MoEConfig:
    """Mixture-of-experts block: ``num_experts`` routed experts of
    ``expert_ff``, the top ``top_k`` taken per token, ``num_shared_experts``
    always-on experts of ``shared_ff`` (0: ``expert_ff``), and the sorted
    dispatch's ``capacity_factor``.  ``router_jitter`` is carried, as in
    the reference, and read by nothing."""

    num_experts: int
    top_k: int
    expert_ff: int
    num_shared_experts: int = 0
    shared_ff: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    def validate(self) -> None:
        if self.num_experts < 1 or not 1 <= self.top_k <= self.num_experts \
                or self.expert_ff < 1:
            raise ValueError(f"moe: {self.num_experts} experts, top "
                             f"{self.top_k}, expert_ff {self.expert_ff}")


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2): keys and values from a
    ``kv_lora_rank`` latent, a decoupled RoPE head dim ``rope_head_dim``
    shared by the heads' keys, ``v_head_dim`` (0: the nope head dim).
    ``q_lora_rank`` 0 is full-rank queries, the only form the reference
    builds."""

    kv_lora_rank: int
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0


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
    """An LM: the dense stack (GQA or MQA attention, or MLA with
    ``mla``; a SwiGLU or GeLU MLP, or the MoE block with ``moe``; RMSNorm
    or layernorm), the RWKV6 stack (layernorm, time-mix, channel-mix),
    the RecurrentGemma hybrid (RG-LRU and local-attention blocks, GeLU
    MLP), or with ``is_encoder_decoder`` a bidirectional encoder of
    ``num_encoder_layers`` dense blocks and a causal decoder of
    ``num_layers`` blocks with cross-attention.  ``frontend`` (vision,
    audio) is a stub: the model takes pre-computed embeddings, a vision
    model's prepended to its tokens', an audio encoder-decoder's as the
    encoder's input.  Parameters are fp32 (``param_dtype``); activations
    run in ``dtype``.  ``remat`` recomputes each layer's activations in
    the training backward.  The reference's ``tp_pad_heads`` pads query
    heads for tensor parallelism, which one card does not have, and is
    left out."""

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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
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

    @property
    def supports_long_context(self) -> bool:
        """Decode over a 500k state is sub-quadratic: the recurrent
        stacks (RWKV6, and the hybrid, whose attention is windowed)."""
        return self.recurrent is not None

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
        if self.moe is not None:
            self.moe.validate()
        if self.recurrent is not None and \
                self.recurrent.kind not in ("rwkv6", "rglru"):
            raise ValueError(f"{self.name}: recurrent kind "
                             f"{self.recurrent.kind!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"{self.name}: dtype {self.dtype!r}")
        if self.param_dtype != "float32":
            raise ValueError(f"{self.name}: parameters are fp32 in the port "
                             f"(got {self.param_dtype!r})")

    def param_count(self, active_only: bool = False) -> int:
        """The exact parameter count of the port's (and the reference's)
        tree; the reference's own ``param_count`` approximates RWKV6, MoE
        and MLA, and leaves out the decoder's cross-attention and part of
        the norms.  ``active_only`` counts what one token touches: of the
        MoE block the router, the shared experts and ``top_k`` of the
        ``num_experts`` routed ones (the roofline's model FLOPs read it)."""
        d, L, hd, f = self.d_model, self.num_layers, self.resolved_head_dim, \
            self.d_ff
        H = self.num_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        norm = 2 * d if self.norm_kind == "layernorm" else d
        n_q, n_kv = H * hd, self.num_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d + (2 * hd if self.qk_norm
                                                   else 0)
        n_mat = 3 if self.mlp_kind == "swiglu" else 2
        mlp = n_mat * d * f
        if self.mla is not None:
            # wq (d, H, nope + rope), w_dkv (d, r), w_kr (d, rope), kv_norm
            # (r), w_uk (r, H, nope), w_uv (r, H, vd), wo (H, vd, d)
            m = self.mla
            r, vd = m.kv_lora_rank, m.v_head_dim or hd
            attn = d * H * (hd + m.rope_head_dim) + d * r \
                + d * m.rope_head_dim + r + r * H * (hd + vd) + H * vd * d
        if self.moe is not None:
            # router (d, E), E experts' wi / wg / wo, the shared experts'
            # joint (d, n_shared * shared_ff) matrices
            me = self.moe
            shared = (me.shared_ff or me.expert_ff) * me.num_shared_experts
            routed = me.top_k if active_only else me.num_experts
            mlp = d * me.num_experts + n_mat * d * me.expert_ff * routed \
                + n_mat * d * shared
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
        if self.is_encoder_decoder:
            # encoder blocks as dense ones; each decoder block adds the
            # cross-attention (wq, wk, wv, wo) and its norm ``norm_x``
            return (emb + self.num_encoder_layers * per_layer
                    + L * (per_layer + attn + norm) + norm)
        return emb + L * per_layer + norm


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: ``kind`` train | prefill | decode, at
    ``global_batch`` sequences of ``seq_len`` tokens (decode: a cache of
    ``seq_len``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str

    def validate(self) -> None:
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"shape kind {self.kind!r}")


#: the reference's four input-shape cells (``src/repro/config.py``)
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How a run maps onto devices.  On one card the step builders read
    ``microbatch`` (0: no gradient accumulation) alone; ``zero1`` and
    ``fsdp`` shard optimizer state and parameters over a data axis, which
    one card does not have, and are carried with the reference's
    defaults.  ``launch/mesh.py:arch_rules`` reads ``fsdp``,
    ``sequence_parallel`` and ``expert_parallel`` into the rule table of a
    production mesh's shape."""

    fsdp: bool = False
    zero1: bool = True
    sequence_parallel: bool = True  # shard layer-boundary activations on seq
    expert_parallel: bool = True  # shard MoE experts over the model axis
    microbatch: int = 0


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
    name: str = "sgd"  # sgd | sgdm | adamw
    lr: float = 0.1
    momentum: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
