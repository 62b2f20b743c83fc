"""Plain PyTorch versions of the wire kernels (the reference's
``kernels/ref.py`` wire subset, operation for operation).

CPU tensors take these on the main path; on a card they are what
``chip_smoke.py`` holds each CUDA kernel against.  Scalars that divide or
scale a tensor are 0-d tensors on the tensor's device, never Python
numbers: PyTorch's CUDA true division by a host scalar multiplies by the
reciprocal, which is an ulp away from the kernel's (and the reference's)
division.
"""
from __future__ import annotations

import torch

BLOCK = 256
HALF = BLOCK // 2


def _nibble_join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int4 arrays (int32) -> one two's-complement int8 byte array."""
    v = ((hi & 0xF) << 4) | (lo & 0xF)
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def _nibble_split(p: torch.Tensor):
    """int8 bytes -> (lo, hi) sign-extended int4 values (int32); ``>>`` on
    a signed tensor is arithmetic."""
    pr = p.to(torch.int32)
    return ((pr & 0xF) ^ 8) - 8, pr >> 4


def pack_nibbles_ref(q: torch.Tensor, axis: int = -1,
                     block: int = BLOCK) -> torch.Tensor:
    """Two int4 nibbles per byte, paired within each ``block`` of ``axis``:
    packed byte ``k`` holds element ``k`` (low) and ``k + block//2``
    (high).  ``axis`` (a whole number of blocks) halves."""
    ax = axis % q.ndim
    s = tuple(q.shape)
    half = block // 2
    qr = q.reshape(s[:ax] + (s[ax] // block, 2, half) + s[ax + 1:])
    lo = qr.select(ax + 1, 0).to(torch.int32)
    hi = qr.select(ax + 1, 1).to(torch.int32)
    return _nibble_join(lo, hi).reshape(s[:ax] + (s[ax] // 2,) + s[ax + 1:])


def unpack_nibbles_ref(p: torch.Tensor, axis: int = -1,
                       block: int = BLOCK) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles_ref` (exact, sign included)."""
    ax = axis % p.ndim
    s = tuple(p.shape)
    half = block // 2
    pr = p.reshape(s[:ax] + (s[ax] // half, half) + s[ax + 1:])
    lo, hi = _nibble_split(pr)
    q = torch.stack([lo, hi], dim=ax + 1)
    return q.to(torch.int8).reshape(s[:ax] + (s[ax] * 2,) + s[ax + 1:])


def pack_tail_ref(q: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack a partial block of ``rem < 256`` elements into ``ceil(rem/2)``
    bytes: byte ``k`` holds element ``k`` (low) and ``k + ceil(rem/2)``
    (high; zero when absent)."""
    ax = axis % q.ndim
    rem = q.shape[ax]
    h = (rem + 1) // 2
    lo = q.narrow(ax, 0, h).to(torch.int32)
    hi = q.narrow(ax, h, rem - h).to(torch.int32)
    if rem - h < h:  # odd rem: the last byte's high nibble is padding
        hi = pad_axis(hi, ax, h)
    return _nibble_join(lo, hi)


def unpack_tail_ref(p: torch.Tensor, rem: int, axis: int = -1
                    ) -> torch.Tensor:
    """Inverse of :func:`pack_tail_ref` for a tail of ``rem`` elements."""
    ax = axis % p.ndim
    lo, hi = _nibble_split(p)
    q = torch.cat([lo, hi], dim=ax).to(torch.int8)
    return q.narrow(ax, 0, rem)


def pad_axis(x: torch.Tensor, ax: int, to: int) -> torch.Tensor:
    """Zero-pad axis ``ax`` of ``x`` up to length ``to`` (no-op if equal)."""
    if x.shape[ax] == to:
        return x
    shape = list(x.shape)
    shape[ax] = to - x.shape[ax]
    return torch.cat([x, x.new_zeros(shape)], dim=ax)


def canonicalize_packed_ref(p: torch.Tensor, d: int, axis: int = -1,
                            block: int = BLOCK) -> torch.Tensor:
    """Trimmed wire ``q_packed`` -> canonical whole-block packed bytes: the
    short-paired tail is re-paired into one zero-padded canonical block.
    Exact integer ops; already-canonical input passes through."""
    ax = axis % p.ndim
    half = block // 2
    nf, rem = d // block, d % block
    nb = -(-d // block)
    if p.shape[ax] == nb * half:
        return p
    parts = []
    if nf:
        parts.append(p.narrow(ax, 0, nf * half))
    if rem:
        tail = p.narrow(ax, nf * half, p.shape[ax] - nf * half)
        q_tail = pad_axis(unpack_tail_ref(tail, rem, axis=ax), ax, block)
        parts.append(pack_nibbles_ref(q_tail, axis=ax, block=block))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)


def loss_weighted_update_ref(g: torch.Tensor, pods: torch.Tensor,
                             w1: torch.Tensor, w2: torch.Tensor,
                             denom: torch.Tensor, any_push: torch.Tensor
                             ) -> torch.Tensor:
    """``any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g``, pods
    accumulated in order.  ``w1``, ``denom``, ``any_push``: 0-d tensors;
    ``w2``: (n_pods,), all on ``g``'s device."""
    gf = g.to(torch.float32)
    acc = w1 * gf
    for i in range(pods.shape[0]):
        acc = acc + w2[i] * pods[i].to(torch.float32)
    merged = acc / denom
    return torch.where(any_push.to(torch.bool), merged, gf).to(g.dtype)


def quantize_int8_ref(x: torch.Tensor):
    """Flat blockwise absmax int8: ``x`` (any shape) -> ``q`` (nb, 256)
    int8 and ``scales`` (nb, 1) fp32 with ``nb = ceil(numel/256)``, the
    last block zero-padded.  ``scale = max(max|x|/127, 1e-12)``, ``q =
    clip(round_half_even(x/scale), -127, 127)``."""
    flat = x.reshape(-1).to(torch.float32)
    blocks = pad_axis(flat, 0, -(-flat.numel() // BLOCK) * BLOCK)
    blocks = blocks.reshape(-1, BLOCK)
    qmax = torch.tensor(127.0, device=x.device)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1, keepdim=True)
                        / qmax, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_int8_ref(q: torch.Tensor, scales: torch.Tensor, shape
                        ) -> torch.Tensor:
    """``q * scales`` flattened and cut to ``prod(shape)`` elements; any
    row count that covers them."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = (q.to(torch.float32) * scales).reshape(-1)
    return flat[:n].reshape(tuple(shape))


def dequant_merge_ref(g: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                      w2: torch.Tensor, denom: torch.Tensor,
                      any_push: torch.Tensor, *, axis: int = -1
                      ) -> torch.Tensor:
    """Merge over the blocked int8 payload in the kernel's order:
    ``acc = denom*g``, then ``acc + w2_i*(q_i*s_i)`` pod by pod, then
    ``acc/denom``, else ``g``.

    ``q`` is the trimmed wire array (one int8 per element of the
    pod-stacked leaf) and ``scales`` has one fp32 per 256-block of
    ``axis`` (``axis - 1`` of ``g``).  On ``q = unpack(q_packed)`` this
    equals :func:`dequant_merge_packed_ref` bit for bit; the reference's
    ``dequant_merge_ref`` sums the pods with a tensordot instead."""
    shape = g.shape
    gf = (g.reshape(1) if g.ndim == 0 else g).to(torch.float32)
    ax = axis % q.ndim
    s = torch.repeat_interleave(scales.to(torch.float32), BLOCK, dim=ax)
    deq = q.to(torch.float32) * s.narrow(ax, 0, q.shape[ax])
    acc = denom * gf
    for i in range(q.shape[0]):
        acc = acc + w2[i] * deq[i]
    out = torch.where(any_push.to(torch.bool), acc / denom, gf)
    return out.reshape(shape).to(g.dtype)


def dequant_merge_packed_ref(g: torch.Tensor, q_packed: torch.Tensor,
                             scales: torch.Tensor, w2: torch.Tensor,
                             denom: torch.Tensor, any_push: torch.Tensor, *,
                             block: int = BLOCK, axis: int = -1
                             ) -> torch.Tensor:
    """Merge over the nibble-packed int4 payload:
    ``any_push ? (denom*g + sum_i w2_i*(q_i*s_i)) / denom : g``.

    ``q_packed``/``scales`` are pod-stacked with the blocks tiling ``axis``
    (``axis - 1`` of ``g``).  Mirrors the reference's
    ``dequant_merge_packed_ref`` op for op: the CUDA kernel is held to it
    bit for bit."""
    shape = g.shape
    gf = g.reshape(1) if g.ndim == 0 else g
    ax = axis % q_packed.ndim
    d_ax = gf.shape[ax - 1] if ax > 0 else gf.shape[ax]
    q_packed = canonicalize_packed_ref(q_packed, d_ax, axis=ax, block=block)
    q = unpack_nibbles_ref(q_packed, axis=ax, block=block)
    if ax != q.ndim - 1:
        q = torch.movedim(q, ax, -1)
        scales = torch.movedim(scales, ax, -1)
        gf = torch.movedim(gf, ax - 1, -1)
    d = gf.shape[-1]
    nb = scales.shape[-1]
    lead = tuple(q.shape[:-1])
    gp = pad_axis(gf, gf.ndim - 1, nb * block)
    deq = q.reshape(lead + (nb, block)).to(torch.float32) \
        * scales[..., None].to(torch.float32)
    deq = deq.reshape(lead + (nb * block,))
    acc = denom * gp.to(torch.float32)
    for i in range(q.shape[0]):
        acc = acc + w2[i] * deq[i]
    merged = acc / denom
    out = torch.where(any_push.to(torch.bool), merged,
                      gp.to(torch.float32))[..., :d]
    if ax != q.ndim - 1:
        out = torch.movedim(out, -1, ax - 1)
    return out.reshape(shape).to(g.dtype)
