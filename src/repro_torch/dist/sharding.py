"""Logical-axis -> mesh-axis sharding rules (the reference's
``dist/sharding.py``).

Every parameter leaf has *logical* axis names ("vocab", "ff", "heads",
...; ``models.lm.param_axes``), and an :class:`AxisRules` table maps those
names onto the axes of a mesh, so a run's whole parallelism policy is one
small dict that ``launch/mesh.py:arch_rules`` derives per architecture.

The same logical name may appear twice in one leaf's axes, and two names
may map to one mesh axis (sequence parallelism puts "seq" on "model" while
"act_ff" also wants "model"), so :meth:`AxisRules.spec` deduplicates: a
mesh axis goes to the first logical axis that claims it, and a later
claim degrades to replication, which is always correct, merely less
sharded.

A mesh here is a :class:`MeshShape`: the axis names and their sizes, all
that the rules and the byte bill's ``block_axis`` hint read (a 512-device
production mesh cannot be a live ``DeviceMesh`` on one machine).  A spec
is a tuple with one entry a dimension: None, a mesh axis name, or a tuple
of names, the counterpart of the reference's ``PartitionSpec``.

:meth:`AxisRules.bind` binds a live ``torch.distributed`` ``DeviceMesh``
(the reference binds a ``jax.sharding.Mesh``): then
:meth:`AxisRules.sharding` gives a spec as a :class:`Sharding`, the mesh
and one DTensor placement a mesh axis (``Shard(d)`` where the spec puts
that axis on dimension ``d``, else ``Replicate()``), the counterpart of a
``NamedSharding``, and :func:`constrain` redistributes a DTensor to it
(:func:`redistribute`, on ``torch.distributed``'s collectives).
With no device mesh bound ``sharding`` raises, as the reference's does
with no mesh, and ``constrain`` is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

from repro_torch.utils.trees import tree_map

Tree = Any

#: Rule values: a mesh-axis name, a tuple of mesh-axis names, or None
#: (replicate).  A tuple shards the logical axis over the product of its
#: mesh axes (e.g. batch over ("pod", "data")).
Rule = Any

#: One array's sharding: an entry a dimension, None, a mesh axis or a
#: tuple of mesh axes (the reference's ``PartitionSpec``).
Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh described by its axes: ``names`` and ``sizes`` in order."""
    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.names} vs sizes {self.sizes}")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.sizes

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 when the mesh has no such axis."""
        return dict(zip(self.names, self.sizes)).get(name, 1)


class Sharding(NamedTuple):
    """One array's placement on a device mesh (the reference's
    ``NamedSharding``): the mesh and a DTensor placement per mesh axis."""
    mesh: Any
    placements: Tuple[Any, ...]


def mesh_shape(device_mesh) -> MeshShape:
    """A ``DeviceMesh``'s axes as a :class:`MeshShape`."""
    return MeshShape(tuple(device_mesh.mesh_dim_names),
                     tuple(int(n) for n in device_mesh.shape))


def _placements(spec: Spec, names: Sequence[str]) -> Tuple[Any, ...]:
    """The DTensor placements of ``spec`` over mesh axes ``names``:
    ``Shard(d)`` for an axis the spec puts on dimension ``d``, else
    ``Replicate()``.  A dimension over several mesh axes is sharded by
    each, in mesh-axis order, as a ``PartitionSpec`` tuple is."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (() if entry is None else (entry,)
                     if isinstance(entry, str) else entry):
            dim_of[name] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


@dataclasses.dataclass
class AxisRules:
    """A logical->mesh rule table, with an optional mesh.

    ``rules`` maps logical axis names to mesh axis names (or tuples of
    them, or None).  ``mesh`` (a :class:`MeshShape`) may be None for
    rule-only introspection; ``device_mesh`` is the live
    ``DeviceMesh`` that :meth:`bind` binds, which :meth:`sharding` and
    :func:`constrain` place on."""

    rules: Dict[str, Rule]
    mesh: Optional[MeshShape] = None
    device_mesh: Any = None

    def bind(self, device_mesh) -> "AxisRules":
        """These rules on a live ``DeviceMesh`` (its axes named, e.g.
        ``("data", "model")``); ``mesh`` becomes its shape."""
        return dataclasses.replace(self, mesh=mesh_shape(device_mesh),
                                   device_mesh=device_mesh)

    def spec(self, axes: Sequence[Optional[str]]) -> Spec:
        """The spec of one array's logical axes, mesh axes deduplicated:
        each entry resolves through ``rules``, and a mesh axis an earlier
        entry took is dropped from later ones (first claim wins)."""
        entries = []
        used: set = set()
        for name in axes:
            rule = self.rules.get(name) if name is not None else None
            if rule is None:
                entries.append(None)
                continue
            members = (rule,) if isinstance(rule, str) else tuple(rule)
            free = tuple(m for m in members if m not in used)
            used.update(free)
            if not free:
                entries.append(None)
            elif isinstance(rule, str) or len(free) == 1:
                # a one-name tuple reads as the name, as a PartitionSpec
                # keeps it
                entries.append(free[0])
            else:
                entries.append(free)
        return tuple(entries)

    def sharding(self, axes: Sequence[Optional[str]]) -> Sharding:
        """The placement of one array on the bound device mesh: its
        :meth:`spec` as DTensor placements.  Raises with no device mesh
        bound, as the reference does with no mesh."""
        if self.device_mesh is None:
            raise ValueError("AxisRules has no device mesh bound; cannot "
                             "place an array (bind a DeviceMesh, or use "
                             ".spec for mesh-free specs)")
        return Sharding(self.device_mesh, _placements(
            self.spec(axes), self.device_mesh.mesh_dim_names))


#: Logical axes every model or launch layer may name.  make_rules seeds
#: them all, so ``rules.rules.get(...)`` sees an explicit None instead of
#: a missing key.
_LOGICAL_AXES = (
    # parameter axes
    "layers", "embed", "qkv", "ff", "vocab", "heads", "kv_heads",
    "expert", "expert_ff", "lru",
    # activation axes
    "batch", "seq", "act_embed", "act_ff", "act_heads", "act_kv",
    "act_vocab", "cache_seq", "moe_group",
)


def make_rules(mesh: Optional[MeshShape], *, fsdp: bool = False,
               sequence_parallel: bool = False, multi_pod: bool = False,
               extra: Optional[Dict[str, Rule]] = None) -> AxisRules:
    """The base rule table of the (data, model[, pod]) production mesh:
    everything replicated, except that ``sequence_parallel`` puts the
    layer-boundary "seq" on "model" and ``fsdp`` puts "embed" and "qkv" on
    "data".  ``extra`` (``launch/mesh.py:arch_rules``' per-architecture
    rules) overrides the base entry by entry.  ``multi_pod`` is accepted
    for symmetry: the replica tiers ("pod", "cluster") are claimed by the
    caller's "batch" rule alone, since pods hold model replicas, never
    model shards (:func:`replica_axes`)."""
    del multi_pod
    rules: Dict[str, Rule] = {name: None for name in _LOGICAL_AXES}
    if sequence_parallel:
        rules["seq"] = "model"
    if fsdp:
        rules["embed"] = "data"
        rules["qkv"] = "data"
    if extra:
        rules.update(extra)
    return AxisRules(rules=rules, mesh=mesh)


def replica_axes(mesh: Optional[MeshShape]) -> Tuple[str, ...]:
    """The replica-tier axes of ``mesh``, slow tier first: ``("cluster",
    "pod")`` on the two-tier mesh, ``("pod",)`` on the flat multi-pod
    mesh, empty on a (data, model) mesh or none.  A pod-stacked tree's
    leading rows live on these axes, the axes the Hermes wire gathers
    over."""
    if mesh is None:
        return ()
    return tuple(a for a in ("cluster", "pod") if a in mesh.axis_names)


def redistribute(x, mesh, place: Sequence[Any]):
    """The DTensor ``x`` on ``mesh`` at the placements ``place``, a mesh
    axis at a time, through ``torch.distributed``'s own collectives over
    the mesh axis' group: ``Shard(d) -> Replicate`` all-gathers,
    ``Partial -> Replicate`` all-reduces, ``Replicate -> Shard(d)`` keeps
    this rank's chunk (no collective).  DTensor's ``redistribute`` runs
    the functional collectives instead, and their wait crashes on gloo
    with CUDA tensors (torch 2.11, the card's); the port's placed rounds
    gather through the same calls as here.  ``Partial -> Shard`` (a
    reduce-scatter, which gloo lacks) and a dimension sharded over two
    mesh axes are refused."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    local, now = x.to_local(), list(x.placements)
    for i, (src, dst) in enumerate(zip(now, place)):
        if src == dst:
            continue
        group, n = mesh.get_group(i), mesh.size(i)
        if dst.is_replicate() and src.is_shard():
            d = src.dim
            part = local.movedim(d, 0).contiguous()
            out = part.new_empty((n * part.shape[0],) + part.shape[1:])
            dist.all_gather_into_tensor(out, part, group=group)
            local = out.movedim(0, d)
        elif dst.is_replicate() and src.is_partial():
            local = local.clone()
            dist.all_reduce(local, group=group)
        elif dst.is_shard() and src.is_replicate():
            if local.shape[dst.dim] % n:
                raise ValueError(f"dimension {dst.dim} of {tuple(local.shape)}"
                                 f" does not split over {n}")
            local = local.chunk(n, dim=dst.dim)[mesh.get_local_rank(i)]
        else:
            raise NotImplementedError(f"redistribute {src} -> {dst} on mesh "
                                      f"axis {i}")
        now[i] = dst
    sharded = [p.dim for p in now if p.is_shard()]
    if len(sharded) != len(set(sharded)):
        raise NotImplementedError(f"a dimension sharded twice: {now}")
    return DTensor.from_local(local.contiguous(), mesh, now, run_check=False,
                              shape=x.shape, stride=torch.empty(
                                  x.shape, device="meta").stride())


def constrain(x, rules: Optional[AxisRules], *axes: Optional[str]):
    """A sharding constraint by logical axis names (the reference's
    ``with_sharding_constraint``): on a bound device mesh, ``x`` as a
    DTensor at ``rules.sharding(axes)`` (:func:`redistribute`); a plain
    tensor is taken as the whole array, the same on every rank of the
    mesh, and sliced to its placement without a collective.  The identity
    with no rules or no device mesh, as in the reference, so the same
    model code runs everywhere."""
    if rules is None or rules.device_mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh, place = rules.sharding(axes)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return redistribute(x, mesh, place)


def param_sharding_tree(axes_tree: Tree, rules: AxisRules) -> Tree:
    """A tree of logical-axes tuples (``models.lm.param_axes``) as a tree
    of specs, one a leaf, or with a device mesh bound of
    :class:`Sharding`s."""
    if rules.device_mesh is None:
        return tree_map(rules.spec, axes_tree)
    return tree_map(rules.sharding, axes_tree)
