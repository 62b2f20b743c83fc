"""Wire formats of the Hermes push payloads (the reference's
``dist/wire.py``, unplaced subset).

Every format owns its contract: ``encode(leaf) -> payload`` (a dict of
tensors that would cross the pod axis) and ``decode(payload, shape,
dtype)``.  Blocked formats quantize absmax blocks of ``BLOCK`` elements
that tile exactly one axis, ``block_axis(shape)`` (the rightmost axis that
is a whole number of blocks, else the zero-padded last axis), so every
other axis is untouched.  The port keeps the reference's parameter shapes
precisely because this choice depends on them.

``int8`` ships ``q`` trimmed to the real elements, rounded half to even
(deterministic: it takes no noise); its ``fused_merge_group`` is the
CUDA ``dequant_merge`` kernel, one launch for a tree.  ``int4`` ships
``q_packed``: whole 256-blocks nibble-packed and a short tail of ``rem``
elements paired ``(k, k + ceil(rem/2))``, every leaf of a tree packed by
one launch of the CUDA ``pack_int4`` kernel (``encode_group``; plain
PyTorch on a CPU tensor) and unpacked by one of ``unpack_int4``
(``decode_group``); its ``fused_merge_group`` reads the packed payloads
straight into the global leaves.  Registered: ``none``, ``fp16``,
``int8``, ``int4``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.utils.trees import tree_flatten, tree_unflatten

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


def _stacked_axis(g: torch.Tensor, q: torch.Tensor) -> int:
    """The blocked axis of the pod-stacked delta leaf, ``(n_pods,) +
    g.shape``."""
    return block_axis((q.shape[0],) + tuple(g.shape))


class WireFormat:
    """One wire format.  Subclass, set ``name``, implement the contract.

    ``encode_group`` / ``decode_group`` take every leaf of a tree at once
    (leaf ``i`` under ``keys[i]``); by default they loop over the leaves.
    ``fused_merge_group(gs, payloads, w2, denom, any_push)``, optional,
    merges the payloads of leaves blocked off the pod axis straight into
    the global leaves ``gs`` (one launch on a card)."""

    name: str = "?"
    fused_merge_group = None

    def encode(self, x: torch.Tensor, *, key=None, noise=None) -> Payload:
        raise NotImplementedError

    def decode(self, payload: Payload, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    def encode_group(self, xs: Sequence[torch.Tensor], keys, noise=None
                     ) -> List[Payload]:
        return [self.encode(x, key=k, noise=noise) for x, k in zip(xs, keys)]

    def decode_group(self, payloads: Sequence[Payload], shapes, dtypes
                     ) -> List[torch.Tensor]:
        return [self.decode(p, s, dt)
                for p, s, dt in zip(payloads, shapes, dtypes)]


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


class Int8Format(BlockedIntFormat):
    """Blockwise int8 absmax, round half to even: 1 byte/element + scales."""

    name = "int8"

    def encode(self, x, *, key=None, noise=None):
        q, scale, s, ax, d, nb = self._quantize(x, key, noise)
        return {"q": q.narrow(ax, 0, d).contiguous(), "scales": scale}

    def fused_merge_group(self, gs, payloads, w2, denom, any_push):
        return ops.dequant_merge_group(
            [(g, p["q"], p["scales"], _stacked_axis(g, p["q"]))
             for g, p in zip(gs, payloads)], w2, denom, any_push)


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

    def encode_group(self, xs, keys, noise=None):
        """Quantize every leaf (leaf ``i``'s noise under ``keys[i]``, in
        order), then pack them all in one grouped call, tails included."""
        qs = [self._quantize(x, key, noise) for x, key in zip(xs, keys)]
        packed = ops.pack_int4_group([(q, d, ax)
                                      for q, _, _, ax, d, _ in qs])
        return [{"q_packed": p, "scales": scale}
                for p, (_, scale, *_) in zip(packed, qs)]

    def encode(self, x, *, key=None, noise=None):
        return self.encode_group([x], [key], noise)[0]

    def unpack_group(self, payloads: Sequence[Payload], shapes
                     ) -> List[torch.Tensor]:
        """Wire ``q_packed`` -> the trimmed int8 ``q`` (one per element) of
        every leaf, in one grouped call."""
        leaves = []
        for p, shape in zip(payloads, shapes):
            s = norm_shape(shape)
            ax = block_axis(s)
            leaves.append((p["q_packed"], s[ax], ax))
        return ops.unpack_int4_group(leaves)

    def unpack_payload(self, payload: Payload, shape) -> torch.Tensor:
        """Wire ``q_packed`` -> the trimmed int8 ``q`` (one per element)."""
        return self.unpack_group([payload], [shape])[0]

    def decode_group(self, payloads, shapes, dtypes):
        qs = self.unpack_group(payloads, shapes)
        return [BlockedIntFormat.decode(
            self, {"q": q, "scales": p["scales"]}, shape, dtype)
            for q, p, shape, dtype in zip(qs, payloads, shapes, dtypes)]

    def decode(self, payload, shape, dtype):
        return self.decode_group([payload], [shape], [dtype])[0]

    def fused_merge_group(self, gs, payloads, w2, denom, any_push):
        return ops.dequant_merge_packed_group(
            [(g, p["q_packed"], p["scales"], _stacked_axis(g, p["q_packed"]))
             for g, p in zip(gs, payloads)], w2, denom, any_push)


def _zero_noise(round_step, leaf, shape):
    """Rounding noise for a spec-only encode: shapes, no values."""
    return torch.zeros(shape, device="meta")


def payload_buffer_spec(tree, mode: str, n_pods: int):
    """The shapes and dtypes of one round's in-flight payload buffer.

    For an unstacked parameter ``tree``, a tree of per-leaf payload dicts
    mirroring what ``encode_tree`` emits for the ``(n_pods,)``-stacked
    delta: every wire array as a ``meta`` tensor of its shape and dtype.
    The arrays come from the format's own ``encode_group`` run on ``meta``
    tensors (the reference's ``eval_shape``), so the spec cannot drift from
    the wire the push bills."""
    fmt = get_format(mode)
    leaves, treedef = tree_flatten(tree)
    stacked = [torch.empty((int(n_pods),) + norm_shape(x.shape),
                           dtype=torch.float32, device="meta")
               for x in leaves]
    payloads = fmt.encode_group(stacked, [(0, i) for i in range(len(leaves))],
                                _zero_noise)
    return tree_unflatten(treedef, payloads)


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
register(Int8Format())
register(Int4Format())
