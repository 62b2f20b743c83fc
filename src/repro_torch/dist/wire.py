"""Wire formats of the Hermes push payloads, their byte specs and the
payload gather (the reference's ``dist/wire.py``).

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

The ship (:func:`gather_payloads`, :func:`gather_payloads_tiered`) is the
identity when every pod sits in one process, the reference's
``mesh=None``, and so the bit-exact oracle of a placed round.  Placed
over the process groups of ``launch.mesh.PodGroups``, it all-gathers
every row-stacked wire array along its leading axis with
``torch.distributed.all_gather_into_tensor``, on whatever device the
arrays lie: gloo takes CUDA tensors for it (checked on the H100 machine
with torch 2.11), so one card can host every rank of a gloo group and
nothing stages through the host.  The reference's ``pin_gathered`` and
``pin_tier`` steer GSPMD's layout of values derived from a gather; eager
PyTorch has no such layout, so they have no counterpart here: each rank
decodes what it gathered, locally.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


def _shard_factor(rule, mesh) -> int:
    """Devices ``rule`` splits one axis over (1 unsharded or with no
    mesh); ``mesh`` a ``dist.sharding.MeshShape``."""
    if rule is None or mesh is None:
        return 1
    members = (rule,) if isinstance(rule, str) else tuple(rule)
    f = 1
    for m in members:
        f *= mesh.axis_size(m)
    return f


def block_axis(shape: Sequence[int], *,
               axes: Optional[Sequence[Optional[str]]] = None,
               rules=None) -> int:
    """The axis the absmax blocks tile: the rightmost whole-block axis,
    else the last.  Deterministic in the shape alone, so encode and
    decode need no side channel, and they take this shape-only path.

    ``axes`` (the leaf's logical axes, ``models.lm.param_axes``) and
    ``rules`` (a ``dist.sharding.AxisRules`` with a mesh shape) are the
    reference's advisory sharding hint: the rightmost whole-block axis
    whose per-shard slice is still whole blocks is preferred over one
    sharded out of alignment; with no such axis the shape-only rule
    holds.  Placement planning and the dry-run audit read it (the audit
    holds every leaf of an architecture to no drift between the two)."""
    s = norm_shape(shape)
    if axes is not None and rules is not None:
        axs = list(axes) + [None] * (len(s) - len(axes))
        for ax in range(len(s) - 1, -1, -1):
            if s[ax] % BLOCK != 0:
                continue
            f = _shard_factor(rules.rules.get(axs[ax]) if axs[ax] else None,
                              rules.mesh)
            if s[ax] % f == 0 and (s[ax] // f) % BLOCK == 0:
                return ax
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

    def fold(self, tag: int) -> "GeneratorNoise":
        """A derived stream (the reference's ``fold_in(rng, tag)`` of a
        round's key): the two-tier round's slow-tier re-encode draws from
        ``fold(0x5C1)``."""
        return GeneratorNoise((self.seed * 1_000_003 + int(tag)) % (1 << 62),
                              self.device)


class RowNoise:
    """The noise of this rank's rows of a placed encode: leaf ``i``'s draw
    takes the whole ``(n_rows,) + ...`` shape, as the unplaced encode
    does, and keeps the rows ``rows``, so a placed round rounds every
    element as the unplaced one.  Leaves in ``whole`` are encoded whole
    on every rank and draw as they are."""

    def __init__(self, noise: NoiseFn, rows: slice, n_rows: int,
                 whole=frozenset()):
        self.noise, self.rows, self.n_rows = noise, rows, int(n_rows)
        self.whole = frozenset(whole)

    def __call__(self, round_step, leaf_index, shape):
        if leaf_index in self.whole:
            return self.noise(round_step, leaf_index, shape)
        full = (self.n_rows,) + tuple(shape[1:])
        return self.noise(round_step, leaf_index, full)[self.rows]


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

    def _encode_at(self, x: torch.Tensor, ax: int) -> Payload:
        """The billing twin of ``encode`` with the blocked axis forced to
        ``ax``; a format with no blocked layout ignores it."""
        return self.encode(x, key=(0, 0), noise=_zero_noise)

    def payload_bytes(self, shape, *, axes=None, rules=None) -> int:
        """Wire bytes of one fp32 leaf of ``shape``, *measured* from what
        the format emits for a ``meta`` tensor of that shape (block
        padding, scales and nibble packing included; nothing allocated).
        ``axes`` / ``rules`` are :func:`block_axis`'s hint, and the memo
        is keyed on the resolved blocked axis, so a hint that moves the
        axis re-measures instead of returning the shape-only bill."""
        s = norm_shape(shape)
        ax = block_axis(s, axes=axes, rules=rules)
        cache = self.__dict__.setdefault("_measured_bytes", {})
        got = cache.get((s, ax))
        if got is None:
            got = cache[(s, ax)] = payload_nbytes(self._encode_at(
                torch.empty(s, dtype=torch.float32, device="meta"), ax))
        return got


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
        """Round ``y`` (the scaled blocks) in place."""
        return y.round_()

    def _quantize(self, x: torch.Tensor, key, noise,
                  ax: Optional[int] = None):
        """Whole-block quantization along ``ax`` (default
        :func:`block_axis`): (q_padded, scales, s, ax, d, nb)."""
        s = norm_shape(x.shape)
        ax = block_axis(s) if ax is None else ax
        d = s[ax]
        nb = -(-d // BLOCK)
        xb = ref.pad_axis(x.reshape(s).to(torch.float32), ax, nb * BLOCK)
        xb = xb.reshape(s[:ax] + (nb, BLOCK) + s[ax + 1:])
        # 0-d device divisors: see kernels/ref.py on CUDA scalar division
        qmax = torch.tensor(float(self.qmax), device=x.device)
        scale = torch.amax(torch.abs(xb), dim=ax + 1, keepdim=True) / qmax
        scale = torch.clamp(scale, min=1e-12)
        # in place from here on (bitwise the out-of-place ops): at a
        # vocabulary table the widened leaf's temporaries are the encode's
        # peak memory
        y = xb / scale
        del xb
        q = self._round(y, key, noise).clamp_(-float(self.qmax),
                                              float(self.qmax))
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
        return self._encode_at(x, None, key, noise)

    def _encode_at(self, x, ax, key=(0, 0), noise=None):
        q, scale, s, ax, d, nb = self._quantize(x, key, noise, ax)
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
        return y.add_(u).floor_()

    def encode_group(self, xs, keys, noise=None, axes=None):
        """Quantize every leaf (leaf ``i``'s noise under ``keys[i]``, in
        order; blocked on ``axes[i]`` when given), then pack them all in
        one grouped call, tails included."""
        axes = [None] * len(xs) if axes is None else axes
        qs = [self._quantize(x, key, noise, ax)
              for x, key, ax in zip(xs, keys, axes)]
        packed = ops.pack_int4_group([(q, d, ax)
                                      for q, _, _, ax, d, _ in qs])
        return [{"q_packed": p, "scales": scale}
                for p, (_, scale, *_) in zip(packed, qs)]

    def encode(self, x, *, key=None, noise=None):
        return self.encode_group([x], [key], noise)[0]

    def _encode_at(self, x, ax):
        return self.encode_group([x], [(0, 0)], _zero_noise, [ax])[0]

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


def row_local(mode: str, shape, *row_counts: int) -> bool:
    """Is a leaf's encode row by row at every one of ``row_counts``
    stackings?  A blocked format whose blocks tile the stacking axis
    itself (a stacked scalar: the reference's non-pinnable leaf) is not:
    its rows must meet on one rank before they are encoded."""
    if not isinstance(get_format(mode), BlockedIntFormat):
        return True
    rest = tuple(int(d) for d in shape)
    return all(block_axis((int(n),) + rest) >= 1 for n in row_counts)


def all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``x``'s rows from every rank of ``group`` (``size`` ranks), stacked
    in rank order along dim 0; the identity for a group of one."""
    if size <= 1:
        return x
    x = x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def gather_payloads(payloads, groups=None, n_pods: Optional[int] = None, *,
                    axis: str = "pod"):
    """Ship the encoded payloads across the ``axis`` tier of ``groups``
    (a ``launch.mesh.PodGroups``; ``"pod"``, or ``"cluster"`` for the
    two-tier round's slow tier).

    The identity when ``groups`` is None (every pod in one process) or the
    tier has one rank, so the unplaced call is the bit-exact oracle of the
    placed one.  Otherwise every wire array whose leading dim is this
    rank's share of the ``n_pods`` rows (default: the tier's full row
    count) is all-gathered along it; other arrays pass through, as in the
    reference's ``_pinnable``.  Every rank must pass trees of one
    structure: they issue the same collectives in the same order."""
    if groups is None:
        return payloads
    group, size = groups.group(axis)
    if size <= 1:
        return payloads
    if n_pods is None:
        n_pods = groups.n_pods if axis == "pod" else groups.n_clusters
    local = int(n_pods) // size
    return _gather_rows_of(payloads, group, size, local)


def gather_payloads_tiered(payloads, groups=None,
                           n_rows: Optional[int] = None):
    """The fast tier of the two-tier ship: gather the row-stacked payloads
    over this rank's intra-cluster group only, so each rank ends up with
    its own cluster's rows and never another cluster's.  Falls back to the
    flat :func:`gather_payloads` when ``groups`` has no cluster tier;
    the identity when ``groups`` is None."""
    if groups is None:
        return payloads
    if groups.n_clusters <= 1:
        return gather_payloads(payloads, groups, n_rows)
    group, size = groups.group("intra")
    n_rows = groups.n_pods if n_rows is None else int(n_rows)
    return _gather_rows_of(payloads, group, size, n_rows // groups.size)


def _gather_rows_of(payloads, group, size: int, local: int):
    leaves, treedef = tree_flatten(payloads)
    return tree_unflatten(treedef, [
        all_gather_rows(a, group, size)
        if a.ndim >= 1 and a.shape[0] == local else a for a in leaves])


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def wire_operand_specs(tree, mode: str, n_pods: int, *, rows: int = 1,
                       n_clusters: Optional[int] = None
                       ) -> List[Tuple[str, Tuple[int, ...], int]]:
    """The operands a rank all-gathers in one placed round's ship, in the
    order it gathers them: ``(dtype name, per-rank dims, bytes)``.

    ``tree`` is an unstacked parameter tree (tensors of any device,
    ``meta`` included); a rank holds ``rows`` of the ``n_pods`` pod rows.
    First the leaves that are not :func:`row_local` (also at
    ``n_clusters`` rows, for the two-tier round): their pre-encode rows,
    ``(rows,) + leaf`` in the leaf dtype, since every rank encodes such a
    leaf whole.  Then every wire array of the others, ``(rows,) + rest``,
    from the format's own ``encode_group`` run on ``meta`` tensors (as
    :func:`payload_buffer_spec`), so the spec cannot drift from the wire;
    ``none`` ships the stacked leaves themselves.  At ``rows=1`` and a
    tree of row-local leaves these are the reference's
    ``wire_operand_specs``; the two-tier round's fast tier gathers the
    same operands over its intra-cluster group."""
    counts = (n_pods,) if n_clusters is None else (n_pods, n_clusters)
    leaves = tree_flatten(tree)[0]
    local = [row_local(mode, x.shape, *counts) for x in leaves]
    specs = [(x.dtype, (int(rows),) + tuple(x.shape))
             for x, ok in zip(leaves, local) if not ok]
    stacked = [torch.empty((int(rows),) + tuple(x.shape), dtype=x.dtype,
                           device="meta")
               for x, ok in zip(leaves, local) if ok]
    payloads = get_format(mode).encode_group(
        stacked, [(0, i) for i in range(len(stacked))], _zero_noise)
    specs += [(a.dtype, tuple(a.shape)) for a in tree_flatten(payloads)[0]]
    return [(_dtype_name(dt), tuple(int(d) for d in dims),
             math.prod(dims) * torch.empty((), dtype=dt).element_size())
            for dt, dims in specs]


def cluster_wire_operand_specs(tree, mode: str, n_clusters: int, *,
                               n_pods: Optional[int] = None
                               ) -> List[Tuple[str, Tuple[int, ...], int]]:
    """The slow-tier operands of one placed two-tier round: each rank
    gathers its cluster's re-encoded partial, one row, over the
    cross-cluster group.  That is :func:`wire_operand_specs` of the same
    tree at ``n_clusters`` rows, one a rank, without the leaves that are
    not row-local (every rank computes those whole, so they cross no tier
    here): slow-tier bytes scale with ``n_clusters``, not ``n_pods``."""
    counts = (n_clusters,) if n_pods is None else (n_clusters, n_pods)
    keep = [x for x in tree_flatten(tree)[0]
            if row_local(mode, x.shape, *counts)]
    return wire_operand_specs(keep, mode, n_clusters)


def control_operand_spec(rows: int) -> Tuple[str, Tuple[int, ...], int]:
    """The gate exchange of a placed round, billed apart from the payload
    (the reference's ``control_bytes``): each rank gathers its pods' loss
    and gate bit as ``rows`` fp32 pairs, whether or not the round opens."""
    return ("float32", (int(rows), 2), 8 * int(rows))


def classify_round_collectives(records: List[Dict], specs, *,
                               control_bytes: Optional[int] = None,
                               n_pods: int = 2,
                               n_clusters: Optional[int] = None,
                               cluster_records: Optional[List[Dict]] = None,
                               cluster_specs=None) -> Dict:
    """Match a round's pod-crossing collective operands against the
    expected wire specs (:func:`wire_operand_specs`); the classification
    itself is ``analysis.collectives.classify_collectives``, where the
    collective-placement rule reuses it.  With ``n_clusters`` (two-tier
    rounds), ``records`` is the pod-crossing set and ``cluster_records``
    its cluster-crossing subset: the rest is classified against ``specs``
    (the fast tier) and ``cluster_records`` against ``cluster_specs``
    (:func:`cluster_wire_operand_specs`), under a ``"cluster"`` key."""
    from repro_torch.analysis.collectives import classify_collectives
    if n_clusters is None or cluster_records is None:
        return classify_collectives(records, specs,
                                    control_bytes=control_bytes,
                                    n_pods=n_pods)
    cluster_ids = {id(r) for r in cluster_records}
    intra = [r for r in records if id(r) not in cluster_ids]
    out = classify_collectives(intra, specs, control_bytes=control_bytes,
                               n_pods=n_pods)
    out["cluster"] = classify_collectives(
        cluster_records, list(cluster_specs or ()),
        control_bytes=control_bytes, n_pods=n_pods)
    return out


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
