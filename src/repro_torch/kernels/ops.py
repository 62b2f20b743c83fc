"""Kernel dispatch: a CUDA tensor goes to the CUDA kernel, a CPU tensor to
its plain PyTorch version.  There is no other route: a CUDA tensor reaches
the kernel or an exception, never the plain version.

Under a cost counter (``analysis/cost.py``) each entry charges its kernel
once a call, ``kernel:<name>`` with its module's ``cost``, whatever runs:
the kernel on a card, the plain version on the CPU (its own ops
uncharged), and on ``meta`` tensors nothing, the entry returning empty
outputs of the right shapes.  Outside a counter an entry only picks the
route: no cost or shape is worked out."""
from __future__ import annotations

import functools

import torch

from repro_torch.analysis.cost import active, charge_kernel
from repro_torch.kernels import dequant_merge as _dqm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import loss_weighted_update as _lwu
from repro_torch.kernels import pack as _pk
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import rglru_scan as _lru
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels.ref import BLOCK


def _entry(cuda, plain):
    """An entry: ``cuda(*args, **kw)`` if its lead tensor (the first
    argument, or a group's first leaf) is on a card, else ``plain``; an
    empty group goes to ``plain``.  The decorated function gives the
    call's ``(name, cost, meta)`` for :func:`charge_kernel`, and runs only
    under a counter."""
    def wrap(charge):
        @functools.wraps(charge)
        def entry(*args, **kw):
            lead = args[0]
            if isinstance(lead, (list, tuple)):
                if not lead:
                    return plain(*args, **kw)
                lead = lead[0][0]
            run = cuda if lead.is_cuda else plain
            if active() is None:
                return run(*args, **kw)
            name, cost, meta = charge(*args, **kw)
            return charge_kernel(name, cost, meta, lambda: run(*args, **kw),
                                 lead.is_meta)
        return entry
    return wrap


def _resized(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """An empty int8 array of ``t``'s shape with ``n`` along ``axis``."""
    shape = list(t.shape)
    shape[axis % t.ndim] = n
    return t.new_empty(shape, dtype=torch.int8)


@_entry(_pk.pack_int4_cuda, _pk.pack_int4_plain)
def pack_int4(q: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Two int4 nibbles per int8 byte along the blocked ``axis``."""
    d = q.shape[axis]
    return ("pack_int4",
            lambda: _pk.cost("pack_int4", [(q.shape, d, axis)]),
            lambda: _resized(q, axis, d // 2))


@_entry(_pk.unpack_int4_cuda, _pk.unpack_int4_plain)
def unpack_int4(p: torch.Tensor, *, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (exact, sign included)."""
    d = 2 * p.shape[axis]
    return ("unpack_int4",
            lambda: _pk.cost("unpack_int4", [(p.shape, d, axis)]),
            lambda: _resized(p, axis, d))


def _group_shapes(leaves):
    return [(t.shape, d, ax) for t, d, ax in leaves]


@_entry(_pk.pack_int4_group_cuda, _pk.pack_int4_group_plain)
def pack_int4_group(leaves):
    """Pack every leaf ``(q, d, axis)`` into its wire bytes, whole blocks
    and tail: one launch on a card."""
    return ("pack_int4",
            lambda: _pk.cost("pack_int4", _group_shapes(leaves)),
            lambda: [_resized(q, ax, _pk.wire_rows(d))
                     for q, d, ax in leaves])


@_entry(_pk.unpack_int4_group_cuda, _pk.unpack_int4_group_plain)
def unpack_int4_group(leaves):
    """Unpack every wire leaf ``(p, d, axis)`` into its ``d`` nibbles along
    ``axis``: one launch on a card."""
    return ("unpack_int4",
            lambda: _pk.cost("unpack_int4", _group_shapes(leaves)),
            lambda: [_resized(p, ax, d) for p, d, ax in leaves])


@_entry(_qz.quantize_int8_cuda, _qz.quantize_int8_plain)
def quantize_int8(x: torch.Tensor):
    """Flat blockwise absmax int8: ``(q (nb, 256), scales (nb, 1))``."""
    nb = -(-x.numel() // BLOCK)
    return ("quantize_int8",
            lambda: _qz.cost("quantize_int8", x.shape, x.dtype),
            lambda: (x.new_empty((nb, BLOCK), dtype=torch.int8),
                     x.new_empty((nb, 1), dtype=torch.float32)))


@_entry(_qz.dequantize_int8_cuda, _qz.dequantize_int8_plain)
def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, shape
                    ) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`, cut to ``prod(shape)`` elements."""
    return ("dequantize_int8",
            lambda: _qz.cost("dequantize_int8", tuple(shape)),
            lambda: q.new_empty(tuple(shape), dtype=torch.float32))


def _merge_cost(leaves):
    """A merge's ``cost`` over ``(g, q, scales, axis)`` leaves."""
    return _dqm.cost([(g.shape, g.dtype, q.shape, s.shape)
                      for g, q, s, _ in leaves], leaves[0][1].shape[0])


@_entry(_dqm.dequant_merge_cuda, _dqm.dequant_merge_plain)
def dequant_merge(g, q, scales, w2, denom, any_push, *,
                  axis: int = -1) -> torch.Tensor:
    """Merge blocked int8 payloads straight into the global leaf."""
    return ("dequant_merge",
            lambda: _merge_cost([(g, q, scales, axis)]),
            lambda: torch.empty_like(g))


@_entry(_dqm.dequant_merge_packed_cuda, _dqm.dequant_merge_packed_plain)
def dequant_merge_packed(g, q_packed, scales, w2, denom, any_push, *,
                         axis: int = -1) -> torch.Tensor:
    """Merge nibble-packed int4 payloads straight into the global leaf."""
    return ("dequant_merge_packed",
            lambda: _merge_cost([(g, q_packed, scales, axis)]),
            lambda: torch.empty_like(g))


@_entry(_dqm.dequant_merge_group_cuda, _dqm.dequant_merge_group_plain)
def dequant_merge_group(leaves, w2, denom, any_push):
    """Merge int8 payloads into their global leaves, ``leaves`` a list of
    ``(g, q, scales, axis)``: one launch on a card."""
    return ("dequant_merge", lambda: _merge_cost(leaves),
            lambda: [torch.empty_like(g) for g, *_ in leaves])


@_entry(_dqm.dequant_merge_packed_group_cuda,
        _dqm.dequant_merge_packed_group_plain)
def dequant_merge_packed_group(leaves, w2, denom, any_push):
    """Merge int4 payloads into their global leaves, ``leaves`` a list of
    ``(g, q_packed, scales, axis)``: one launch on a card."""
    return ("dequant_merge_packed", lambda: _merge_cost(leaves),
            lambda: [torch.empty_like(g) for g, *_ in leaves])


@_entry(_lwu.loss_weighted_update_cuda, _lwu.loss_weighted_update_plain)
def loss_weighted_update(g, pods, w1, w2, denom, any_push) -> torch.Tensor:
    """``any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g``."""
    return ("loss_weighted_update",
            lambda: _lwu.cost([(g.shape, g.dtype, pods.dtype)],
                              pods.shape[0]),
            lambda: torch.empty_like(g))


@_entry(_lwu.loss_weighted_update_group_cuda,
        _lwu.loss_weighted_update_group_plain)
def loss_weighted_update_group(leaves, w1, w2, denom, any_push):
    """:func:`loss_weighted_update` of every leaf ``(g, pods)``: one launch
    a dtype on a card."""
    return ("loss_weighted_update",
            lambda: _lwu.cost([(g.shape, g.dtype, p.dtype)
                               for g, p in leaves], leaves[0][1].shape[0]),
            lambda: [torch.empty_like(g) for g, _ in leaves])


@_entry(_fa.flash_attention_cuda, _fa.flash_attention_plain)
def flash_attention(q, k, v, q_positions, kv_positions, *,
                    causal: bool = True, window: int = 0,
                    scale=None) -> torch.Tensor:
    """GQA attention masked by positions: q (B,Sq,H,D), k/v (B,Skv,K,Dv)
    -> (B,Sq,H,Dv) in q's dtype.  Charged as the kernel
    :func:`flash_attention.design` picks, over the pairs the positions
    make visible (on ``meta`` tensors, :func:`flash_attention.
    assumed_counts`)."""
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]

    def cost():
        if q.is_meta:
            pairs, seen = _fa.assumed_counts(Sq, k.shape[1], causal=causal,
                                             window=window)
        else:
            pairs, seen = _fa.visible_counts(q_positions, kv_positions,
                                             causal=causal, window=window)
        return _fa.cost(q.shape, k.shape, q.dtype, Dv, pairs=pairs,
                        seen=seen)

    return (_fa.design(Sq, D, q.dtype, Dv), cost,
            lambda: q.new_empty((B, Sq, H, Dv)))


@_entry(_wkv.wkv6_cuda, _wkv.wkv6_plain)
def wkv6(r, k, v, log_w, u, state):
    """The exact WKV6 recurrence: (B,T,H,D) inputs -> (y, new state)."""
    B, T, H, D = r.shape
    return ("wkv6", lambda: _wkv.cost(r.shape, r.dtype, u.dtype),
            lambda: (torch.empty_like(r),
                     r.new_empty((B, H, D, D), dtype=torch.float32)))


@_entry(_lru.rglru_cuda, _lru.rglru_plain)
def rglru(a, b, h0=None):
    """The diagonal recurrence ``h_t = a_t h_{t-1} + b_t``: fp32 (B,T,W)
    inputs -> (every step's h, the last h)."""
    B, T, W = a.shape
    return ("rglru", lambda: _lru.cost(a.shape, h0 is not None),
            lambda: (a.new_empty((B, T, W), dtype=torch.float32),
                     a.new_empty((B, W), dtype=torch.float32)))


def kernel_lint_cases():
    """``(label, LaunchSpec)`` for every ported kernel (the reference's
    ``kernels/ops.py:wire_lint_cases``).

    The static tile lint (``repro_torch.analysis.KernelTileLint``) reads
    each spec and its ``.cu`` source; nothing launches.  The wire kernels
    take the reference's shapes: a ``(4, 512)`` leaf (two 256-element
    blocks a row) and two pods; pack, unpack and the merges also take
    lm100m's ``wq`` layout (blocked on a middle axis: column tiles for the
    merges, whole-unit tiles of 16 KB for pack and unpack) at 2 layers
    and 4 pods.  The three merges also take bf16 leaves: qwen3-8b's
    ``wq`` at one layer (row tiles, as every leaf of that tree takes) and
    lm100m's ``wq`` layout (column tiles).  The model kernels take shapes
    their real
    tiling divides.  Flash attention has three designs: the SIMT kernel
    (fp32 prefill, 128 queries and keys, two 64-row tiles, at head dims 64
    and 256 on one KV head); the split-KV decode kernel and its combine
    at recurrentgemma-2b decode (B 4, 10 heads of 256 on one KV head, the
    2048-slot ring, bf16) and at lm100m decode (B 8, 12 heads of 64 on 4,
    fp32, a 640-slot cache: the 577 slots of the serve leave a ragged
    last split); the wgmma bf16 prefill at head dims 64 and 256; and
    MLA's q / k head dim against its v head dim, deepseek-v2-lite's
    (192, 128) on all three designs (decode at B 4, 16 heads, a
    1152-slot cache, bf16) and its smoke config's (24, 16) on the SIMT
    and decode kernels; the encoder-decoder's (seamless-m4t-large-v2)
    encoder prefill (16 heads of 64 on 16 KV heads) and cross decode (B 4
    over 1152 encoder keys, where the serve's 1024 leave a ragged last
    split), and llava-next-34b's G 7 (56 heads of 128 on 8) in prefill
    and in decode over a 6144-slot cache (the serve's 6176: ragged), bf16.
    WKV6
    takes 32 steps (two ring slots) of two heads of 64 (a cluster of four
    blocks each) and decode at batch 2; the RG-LRU 64 steps (two ring
    slots) of 128 channels (four blocks) and decode.
    """
    pods, g, wq = 2, (4, 512), (2, 768, 12, 64)
    qwen_wq = (1, 4096, 4096)
    rg = ((4, 1, 10, 256), (4, 2048, 1, 256), "bfloat16")
    lm = ((8, 1, 12, 64), (8, 640, 4, 64), "float32")
    mla = ((4, 1, 16, 192), (4, 1152, 16, 192), "bfloat16", 128)
    mla_smoke = ((2, 1, 4, 24), (2, 64, 4, 24), "float32", 16)
    mla_prefill = ((1, 128, 16, 192), (1, 128, 16, 192))
    cross = ((4, 1, 16, 64), (4, 1152, 16, 64), "bfloat16")
    g7 = ((2, 1, 56, 128), (2, 6144, 8, 128), "bfloat16")
    return [
        ("quantize_int8", _qz.launch_spec("quantize_int8", g)),
        ("dequantize_int8", _qz.launch_spec("dequantize_int8", g)),
        ("pack_int4", _pk.launch_spec("pack_int4", g)),
        ("unpack_int4", _pk.launch_spec("unpack_int4", (4, 256))),
        ("pack_int4[wq]", _pk.launch_spec("pack_int4", (4,) + wq, 2)),
        ("unpack_int4[wq]",
         _pk.launch_spec("unpack_int4", (4, 2, 384, 12, 64), 2)),
        ("loss_weighted_update", _lwu.launch_spec(g, pods)),
        ("dequant_merge", _dqm.launch_spec("dequant_merge", g, pods)),
        ("dequant_merge_packed",
         _dqm.launch_spec("dequant_merge_packed", g, pods)),
        ("dequant_merge[wq]", _dqm.launch_spec("dequant_merge", wq, 4, 2)),
        ("dequant_merge_packed[wq]",
         _dqm.launch_spec("dequant_merge_packed", wq, 4, 2)),
        ("loss_weighted_update[bf16]",
         _lwu.launch_spec(qwen_wq, pods, "bfloat16")),
        ("dequant_merge[bf16]",
         _dqm.launch_spec("dequant_merge", qwen_wq, pods, -1, "bfloat16")),
        ("dequant_merge_packed[bf16]",
         _dqm.launch_spec("dequant_merge_packed", qwen_wq, pods, -1,
                          "bfloat16")),
        ("dequant_merge[wq bf16]",
         _dqm.launch_spec("dequant_merge", wq, 4, 2, "bfloat16")),
        ("dequant_merge_packed[wq bf16]",
         _dqm.launch_spec("dequant_merge_packed", wq, 4, 2, "bfloat16")),
        ("flash_attention[D64]",
         _fa.launch_spec((1, 128, 4, 64), (1, 128, 2, 64), "float32")),
        ("flash_attention[D256]",
         _fa.launch_spec((1, 128, 2, 256), (1, 128, 1, 256), "float32")),
        ("flash_decode[rg]", _fa.launch_spec(*rg)),
        ("flash_decode[lm100m]", _fa.launch_spec(*lm)),
        ("flash_decode_combine[rg]", _fa.combine_launch_spec(*rg)),
        ("flash_decode_combine[lm100m]", _fa.combine_launch_spec(*lm)),
        ("flash_prefill[D64]",
         _fa.launch_spec((1, 128, 4, 64), (1, 128, 2, 64), "bfloat16")),
        ("flash_prefill[D256]",
         _fa.launch_spec((1, 128, 2, 256), (1, 128, 1, 256), "bfloat16")),
        ("flash_attention[D192/128]",
         _fa.launch_spec(*mla_prefill, "float32", 128)),
        ("flash_prefill[D192/128]",
         _fa.launch_spec(*mla_prefill, "bfloat16", 128)),
        ("flash_decode[mla]", _fa.launch_spec(*mla)),
        ("flash_decode_combine[mla]", _fa.combine_launch_spec(*mla)),
        ("flash_attention[D24/16]",
         _fa.launch_spec((1, 128, 4, 24), (1, 128, 4, 24), "float32", 16)),
        ("flash_decode[D24/16]", _fa.launch_spec(*mla_smoke)),
        ("flash_prefill[encoder]",
         _fa.launch_spec((1, 128, 16, 64), (1, 128, 16, 64), "bfloat16")),
        ("flash_decode[cross]", _fa.launch_spec(*cross)),
        ("flash_decode_combine[cross]", _fa.combine_launch_spec(*cross)),
        ("flash_prefill[G7]",
         _fa.launch_spec((1, 128, 56, 128), (1, 128, 8, 128), "bfloat16")),
        ("flash_decode[G7]", _fa.launch_spec(*g7)),
        ("flash_decode_combine[G7]", _fa.combine_launch_spec(*g7)),
        ("wkv6", _wkv.launch_spec((1, 32, 2, 64), "bfloat16")),
        ("wkv6[decode]", _wkv.launch_spec((2, 1, 2, 64), "bfloat16")),
        ("rglru", _lru.launch_spec((1, 64, 128))),
        ("rglru[decode]", _lru.launch_spec((2, 1, 128))),
    ]
