"""Wire formats of the Hermes push payloads (the reference's
``dist/wire.py``, unplaced subset).

Every format owns its contract: ``encode(leaf) -> payload`` (a dict of
tensors that would cross the pod axis) and ``decode(payload, shape,
dtype)``.  Blocked formats quantize absmax blocks of ``BLOCK`` elements
that tile exactly one axis, ``block_axis(shape)`` (the rightmost axis that
is a whole number of blocks, else the zero-padded last axis), so every
other axis is untouched.  The port keeps the reference's parameter shapes
precisely because this choice depends on them.

``int4`` ships ``q_packed``: whole 256-blocks nibble-packed by the CUDA
``pack_int4`` kernel (plain PyTorch on a CPU tensor), a short tail of
``rem`` elements paired ``(k, k + ceil(rem/2))``; its ``fused_merge``
reads the packed payload straight into the global leaf.  Registered:
``none``, ``fp16``, ``int4``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import ops, ref

Payload = Dict[str, torch.Tensor]
#: ``noise(round_step, leaf_index, padded_block_shape) -> U[0, 1)`` tensor
#: (or array) of that shape: the int4 rounding noise of one leaf in one
#: round.  Injectable so a test can hand in the reference's threefry bits.
NoiseFn = Callable[[int, int, Tuple[int, ...]], object]

BLOCK = ref.BLOCK


def resolve_kernel_dispatch(policy: str, device: torch.device) -> bool:
    """Fused-kernel merge or the plain association?  ``"auto"`` runs the
    kernels when the tensors are on a card; ``"on"``/``"off"`` force it."""
    if policy not in ("auto", "on", "off"):
        raise ValueError(
            f"kernel_dispatch policy {policy!r} (want auto|on|off)")
    if policy == "auto":
        return torch.device(device).type == "cuda"
    return policy == "on"


def norm_shape(shape) -> Tuple[int, ...]:
    """Scalars are treated as one-element vectors throughout."""
    s = tuple(int(x) for x in shape)
    return s if s else (1,)


def block_axis(shape: Sequence[int]) -> int:
    """The axis the absmax blocks tile: the rightmost whole-block axis,
    else the last.  Deterministic in the shape alone."""
    s = norm_shape(shape)
    for ax in range(len(s) - 1, -1, -1):
        if s[ax] % BLOCK == 0:
            return ax
    return len(s) - 1


class GeneratorNoise:
    """The port's own int4 rounding noise: ``torch.rand`` from a generator
    on ``device`` seeded per ``(seed, round_step, leaf_index)``, so a round
    and a leaf always draw the same bits (the role of the reference's
    ``fold_in``; the bits themselves differ from threefry)."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def __call__(self, round_step: int, leaf_index: int,
                 shape: Tuple[int, ...]) -> torch.Tensor:
        mixed = ((self.seed * 1_000_003 + round_step) * 1_000_003
                 + leaf_index) % (1 << 63)
        gen = torch.Generator(device=self.device).manual_seed(mixed)
        return torch.rand(shape, generator=gen, device=self.device,
                          dtype=torch.float32)


class WireFormat:
    """One wire format.  Subclass, set ``name``, implement the contract."""

    name: str = "?"
    fused_merge = None  # optional fused payload->global merge

    def encode(self, x: torch.Tensor, *, key=None, noise=None) -> Payload:
        raise NotImplementedError

    def decode(self, payload: Payload, shape, dtype) -> torch.Tensor:
        raise NotImplementedError


class NoneFormat(WireFormat):
    """fp32 leaves verbatim: 4 bytes/element."""

    name = "none"

    def encode(self, x, *, key=None, noise=None):
        return {"x": x}

    def decode(self, payload, shape, dtype):
        return payload["x"].reshape(shape).to(dtype)


class Fp16Format(WireFormat):
    """Half-precision cast (the paper's §IV-D format): 2 bytes/element."""

    name = "fp16"

    def encode(self, x, *, key=None, noise=None):
        return {"h": x.to(torch.float16)}

    def decode(self, payload, shape, dtype):
        return payload["h"].reshape(shape).to(dtype)


class BlockedIntFormat(WireFormat):
    """Shared machinery of the blocked integer formats.

    Per leaf, with ``ax = block_axis(shape)``, ``d = shape[ax]`` and
    ``nb = ceil(d/BLOCK)``: ``q`` holds one int8 in [-qmax, qmax] per real
    element (the block padding is trimmed off the wire) and ``scales`` one
    fp32 absmax/qmax per block, every other axis verbatim.
    """

    qmax: int = 127

    def _round(self, y: torch.Tensor, key, noise) -> torch.Tensor:
        return torch.round(y)

    def _quantize(self, x: torch.Tensor, key, noise):
        """Whole-block quantization: (q_padded, scales, s, ax, d, nb)."""
        s = norm_shape(x.shape)
        ax = block_axis(s)
        d = s[ax]
        nb = -(-d // BLOCK)
        xb = ref.pad_axis(x.reshape(s).to(torch.float32), ax, nb * BLOCK)
        xb = xb.reshape(s[:ax] + (nb, BLOCK) + s[ax + 1:])
        # 0-d device divisors: see kernels/ref.py on CUDA scalar division
        qmax = torch.tensor(float(self.qmax), device=x.device)
        scale = torch.amax(torch.abs(xb), dim=ax + 1, keepdim=True) / qmax
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(self._round(xb / scale, key, noise),
                        -float(self.qmax), float(self.qmax))
        return (q.to(torch.int8).reshape(s[:ax] + (nb * BLOCK,) + s[ax + 1:]),
                scale.reshape(s[:ax] + (nb,) + s[ax + 1:]), s, ax, d, nb)

    def decode(self, payload, shape, dtype):
        q, sc = payload["q"], payload["scales"]
        s = norm_shape(shape)
        ax = block_axis(s)
        d = s[ax]
        nb = sc.shape[ax]
        q = ref.pad_axis(q, ax, nb * BLOCK)  # re-grow the trimmed wire array
        xb = q.reshape(s[:ax] + (nb, BLOCK) + s[ax + 1:]).to(torch.float32) \
            * sc.unsqueeze(ax + 1)
        flat = xb.reshape(s[:ax] + (nb * BLOCK,) + s[ax + 1:])
        return flat.narrow(ax, 0, d).reshape(shape).to(dtype)


class Int4Format(BlockedIntFormat):
    """Blockwise int4 with stochastic rounding, nibble-packed.

    ``q = floor(x/scale + u)``, ``u ~ U[0, 1)``: unbiased in expectation,
    with the error-feedback residual one level up absorbing the rest.
    ``key`` is ``(round_step, leaf_index)`` and ``noise`` a :data:`NoiseFn`
    (default: :class:`GeneratorNoise` with seed 0 on the leaf's device).
    """

    name = "int4"
    qmax = 7
    HALF = BLOCK // 2

    def _round(self, y, key, noise):
        round_step, leaf = key if key is not None else (0, 0)
        if noise is None:
            noise = GeneratorNoise(0, y.device)
        u = torch.as_tensor(noise(round_step, leaf, tuple(y.shape)),
                            dtype=torch.float32, device=y.device)
        return torch.floor(y + u)

    def encode(self, x, *, key=None, noise=None):
        q, scale, s, ax, d, nb = self._quantize(x, key, noise)
        nf, rem = d // BLOCK, d % BLOCK
        parts = []
        if nf:
            head = q.narrow(ax, 0, nf * BLOCK).contiguous()
            parts.append(ops.pack_int4(head, axis=ax))
        if rem:
            parts.append(ref.pack_tail_ref(q.narrow(ax, nf * BLOCK, rem),
                                           axis=ax))
        packed = parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)
        return {"q_packed": packed, "scales": scale}

    def unpack_payload(self, payload: Payload, shape) -> torch.Tensor:
        """Wire ``q_packed`` -> the trimmed int8 ``q`` (one per element)."""
        s = norm_shape(shape)
        ax = block_axis(s)
        d = s[ax]
        nf, rem = d // BLOCK, d % BLOCK
        packed = payload["q_packed"]
        parts = []
        if nf:
            head = packed.narrow(ax, 0, nf * self.HALF).contiguous()
            parts.append(ops.unpack_int4(head, axis=ax))
        if rem:
            tail = packed.narrow(ax, nf * self.HALF,
                                 packed.shape[ax] - nf * self.HALF)
            parts.append(ref.unpack_tail_ref(tail, rem, axis=ax))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)

    def decode(self, payload, shape, dtype):
        q = self.unpack_payload(payload, shape)
        return super().decode({"q": q, "scales": payload["scales"]},
                              shape, dtype)

    def fused_merge(self, g, payload, w2, denom, any_push):
        # the blocked axis of the stacked delta leaf, (n_pods,) + g.shape
        n_pods = payload["q_packed"].shape[0]
        ax = block_axis((n_pods,) + tuple(g.shape))
        return ops.dequant_merge_packed(g, payload["q_packed"],
                                        payload["scales"], w2, denom,
                                        any_push, axis=ax)


def gather_payloads(payloads):
    """Ship the encoded payloads across the pod axis.  With every pod
    stacked on one device (the reference's ``mesh=None``) this is the
    identity; a placed gather over ``torch.distributed`` replaces it in a
    later slice."""
    return payloads


_REGISTRY: Dict[str, WireFormat] = {}


def register(fmt: WireFormat) -> WireFormat:
    if fmt.name in _REGISTRY:
        raise ValueError(f"wire format {fmt.name!r} already registered")
    _REGISTRY[fmt.name] = fmt
    return fmt


def get_format(name: str) -> WireFormat:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown compression mode {name!r} "
                         f"(want one of {available_formats()})") from None


def available_formats() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def payload_nbytes(payload: Payload) -> int:
    """Bytes one encoded leaf puts on the wire (what ``encode`` emitted)."""
    return sum(a.numel() * a.element_size() for a in payload.values())


register(NoneFormat())
register(Fp16Format())
register(Int4Format())
