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
of names, the counterpart of the reference's ``PartitionSpec``.  Binding
a ``torch.distributed`` ``DeviceMesh`` (``AxisRules.sharding`` as DTensor
placements, :func:`constrain` as a redistribute) waits for the next slice
(ROADMAP queue 1 item 9); until then :meth:`AxisRules.sharding` raises,
as the reference's does with no mesh bound.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

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


@dataclasses.dataclass
class AxisRules:
    """A logical->mesh rule table, with an optional mesh.

    ``rules`` maps logical axis names to mesh axis names (or tuples of
    them, or None).  ``mesh`` (a :class:`MeshShape`) may be None for
    rule-only introspection."""

    rules: Dict[str, Rule]
    mesh: Optional[MeshShape] = None

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

    def sharding(self, axes: Sequence[Optional[str]]):
        """The placement of one array on a bound device mesh.  No device
        mesh is bound in the port yet: this raises, as the reference does
        with no mesh."""
        raise ValueError(
            "AxisRules has no device mesh bound (binding a torch DeviceMesh "
            "comes with launch/elastic.py:run_demo, ROADMAP queue 1 item "
            "9); use .spec for mesh-free specs")


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


def constrain(x, rules: Optional[AxisRules], *axes: Optional[str]):
    """A sharding constraint by logical axis names: the identity with no
    rules or no mesh, as in the reference, so the same model code runs
    everywhere.  Every caller in the port passes no mesh."""
    if rules is None or rules.mesh is None:
        return x
    return rules.sharding(axes)  # raises: no device mesh is bound yet


def param_sharding_tree(axes_tree: Tree, rules: AxisRules) -> Tree:
    """A tree of logical-axes tuples (``models.lm.param_axes``) as a tree
    of specs, one a leaf."""
    return tree_map(rules.spec, axes_tree)
