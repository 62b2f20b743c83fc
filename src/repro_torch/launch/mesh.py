"""Process-group layouts of a placed Hermes run (the reference's
``launch/mesh.py``: its pure shape helpers, and ``make_pod_mesh``,
``flatten_cluster_mesh`` and ``regroup_mesh`` as process groups).

The reference places pods on a ``(pod, data, model)`` Mesh, or a
``(cluster, pod, data, model)`` one, in one SPMD program.  The port
places them with processes: one rank holds whole pods on one card (its
data and model axes are 1), and the pod stacking is split over the ranks
of a ``torch.distributed`` group.  Rank ``r`` of a pod group of size
``W`` owns the pod rows ``[r*n_pods/W, (r+1)*n_pods/W)``.  The layout is
cluster-major, as in ``make_pod_mesh``: with ``C`` clusters, cluster
``c`` owns the contiguous ranks ``[c*W/C, (c+1)*W/C)`` and so the pod
rows ``[c*n_pods/C, (c+1)*n_pods/C)``.  Two subgroups carry the two-tier
round: the **intra-cluster** group of a rank's cluster (the fast tier)
and the **cross-cluster** group of the ranks at the same in-cluster
index (the slow tier).

A pod group need not be the default group: after a shrink it holds the
survivors only.  ``PodGroups.members`` lists the **global** ranks of the
group in group-rank order, which is ascending (``dist.new_group`` sorts
the ranks it is given), and ``PodGroups.rank`` is this process's rank
within the group.  The layouts of :func:`rank_layout` are group-local;
every ``dist.new_group`` call takes them through ``members`` to global
ranks.  ``shrink_groups`` and ``grow_groups`` are ``shrink_mesh`` and
``grow_mesh``.

Creating a group is collective over the whole default group: every
process calls every ``dist.new_group`` in the same order, the ones
outside the new group too (they keep nothing of it).  The hashed names
of ``use_local_synchronization=True`` would collide when a resize
recreates a group with the same ranks, as a shrink-and-grow round trip
does.  So every function here that creates groups is called by every
process; a process outside the group passes ``layout=`` (the group's
``(members, n_pods)``, which :func:`shrink_layout` computes on any rank)
in place of a ``PodGroups`` it does not hold.

``make_production_mesh`` describes the reference's production meshes by
their shape alone (``dist.sharding.MeshShape``), and ``arch_rules``
derives an architecture's logical-to-mesh rules on such a shape, table
for table as the reference's: the byte bill's ``block_axis`` hint and the
sharding audits read them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.config import ModelConfig, ParallelConfig
from repro_torch.dist.sharding import AxisRules, MeshShape, make_rules


def pod_mesh_shape(ndev: int, n_pods: int) -> Tuple[int, int, int]:
    """Largest square-ish (pods, data, model) shape for ``ndev`` devices:
    per pod, the model axis is the largest power of two whose square fits
    the per-pod device count.  Raises when fewer than one device per pod
    is available."""
    per_pod = ndev // n_pods
    assert per_pod >= 1, f"{ndev} devices cannot host {n_pods} pods"
    model = 1
    while (model * 2) ** 2 <= per_pod:
        model *= 2
    return (n_pods, per_pod // model, model)


def cluster_mesh_shape(ndev: int, n_clusters: int,
                       pods_per_cluster: int) -> Tuple[int, int, int, int]:
    """(cluster, pod, data, model): the devices split evenly into
    ``n_clusters`` contiguous blocks, each with its own
    :func:`pod_mesh_shape` grid."""
    per_cluster = ndev // n_clusters
    assert per_cluster >= pods_per_cluster >= 1, (
        f"{ndev} devices cannot host {n_clusters} clusters of "
        f"{pods_per_cluster} pods")
    return (n_clusters,) + pod_mesh_shape(per_cluster, pods_per_cluster)


def rank_layout(world: int, n_pods: int, n_clusters: int = 1
                ) -> Tuple[List[List[int]], List[List[int]]]:
    """The rank lists of the two tiers, cluster-major: ``(intra, cross)``,
    ``intra[c]`` the ranks of cluster ``c`` and ``cross[j]`` the ranks at
    in-cluster index ``j``, one per cluster.  Checks that the pods split
    evenly over the ranks, and the ranks and pods over the clusters."""
    if n_pods % world:
        raise ValueError(f"{n_pods} pods do not split evenly over "
                         f"{world} ranks")
    if n_clusters > 1 and (n_pods % n_clusters or world % n_clusters):
        raise ValueError(f"{n_pods} pods on {world} ranks do not split "
                         f"into {n_clusters} equal clusters")
    rpc = world // max(1, n_clusters)
    intra = [list(range(c * rpc, (c + 1) * rpc)) for c in range(n_clusters)]
    cross = [[c * rpc + j for c in range(n_clusters)] for j in range(rpc)]
    return intra, cross


#: a pod group as every process can name it: ``(members, n_pods)``, the
#: global ranks in group-rank order and the pod rows they hold
Layout = Tuple[Tuple[int, ...], int]


@dataclass(frozen=True)
class PodGroups:
    """One rank's view of a placed run: the pod group (``size`` ranks,
    this one ``rank`` within it, ``members`` their global ranks in
    group-rank order; ``None`` means ``0 .. size-1``, the default group),
    its pod rows, and with clusters the two tiers' groups it belongs to
    (``None`` when flat)."""

    n_pods: int
    rank: int
    size: int
    pod: Any
    n_clusters: int = 1
    intra: Any = None
    cross: Any = None
    members: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        members = tuple(range(self.size)) if self.members is None \
            else tuple(int(m) for m in self.members)
        if len(members) != self.size or list(members) != sorted(set(members)):
            raise ValueError(f"members {members} are not {self.size} "
                             f"ascending ranks (dist.new_group sorts them)")
        object.__setattr__(self, "members", members)

    @property
    def layout(self) -> Layout:
        return self.members, self.n_pods

    @property
    def rows_per_rank(self) -> int:
        return self.n_pods // self.size

    @property
    def rows(self) -> slice:
        """This rank's pod rows of the ``(n_pods,)`` stacking."""
        lo = self.rank * self.rows_per_rank
        return slice(lo, lo + self.rows_per_rank)

    @property
    def cluster(self) -> int:
        """This rank's cluster (0 when flat)."""
        return self.rank // (self.size // self.n_clusters)

    def group(self, axis: str):
        """``(process group, size)`` of a tier: ``"pod"`` the pod group,
        ``"intra"`` this rank's cluster, ``"cluster"`` the cross-cluster
        group; ``(None, 1)`` for a tier the layout does not have."""
        if axis == "pod":
            return self.pod, self.size
        if self.n_clusters <= 1:
            return None, 1
        if axis == "intra":
            return self.intra, self.size // self.n_clusters
        if axis == "cluster":
            return self.cross, self.n_clusters
        raise ValueError(f"unknown tier {axis!r} (want pod|intra|cluster)")


def make_pod_groups(n_pods: int, n_clusters: int = 1) -> PodGroups:
    """The placed counterpart of ``make_pod_mesh``: the default process
    group (already initialised) is the pod group, split by cluster with
    ``n_clusters > 1``.  Every rank must call it, in the same order: it
    creates every subgroup."""
    flat = PodGroups(n_pods=int(n_pods), rank=dist.get_rank(),
                     size=dist.get_world_size(), pod=dist.group.WORLD)
    rank_layout(flat.size, flat.n_pods)
    return regroup_groups(flat, n_clusters)


def flatten_cluster_groups(groups: PodGroups) -> PodGroups:
    """Merge the two tiers into the flat pod group (the row layout of
    ``flatten_cluster_mesh``): the rows stay where they are, flat row
    ``c * n_pods/C + p`` being cluster ``c``'s pod ``p``."""
    return replace(groups, n_clusters=1, intra=None, cross=None)


def _new_groups(lists: Sequence[Sequence[int]]) -> Optional[Any]:
    """Create a group for each list of global ranks, in order, and return
    the one holding this process (``None`` if none does).  Collective:
    every process of the default group calls it with the same lists."""
    me, mine = dist.get_rank(), None
    for ranks in lists:
        g = dist.new_group(list(ranks))
        if me in ranks:
            mine = g
    return mine


def _pod_group(layout: Layout) -> Optional[PodGroups]:
    """The flat pod group of ``layout``: created (every process calls),
    then this process's view, or ``None`` outside the group."""
    members, n_pods = tuple(layout[0]), int(layout[1])
    rank_layout(len(members), n_pods)
    pod = _new_groups([members])
    if pod is None:
        return None
    return PodGroups(n_pods=n_pods, rank=dist.get_group_rank(
        pod, dist.get_rank()), size=len(members), pod=pod, members=members)


def regroup_groups(groups: Optional[PodGroups], n_clusters: int, *,
                   layout: Optional[Layout] = None) -> Optional[PodGroups]:
    """Inverse of :func:`flatten_cluster_groups` (``regroup_mesh``): split
    a flat pod group cluster-major into ``n_clusters`` tiers.  Collective
    over the default group: every process creates every intra- and
    cross-cluster group, in the same order, the global ranks being the
    group-local ones of :func:`rank_layout` taken through ``members``;
    each keeps its own.  A process outside the pod group passes
    ``groups=None`` and the group's ``layout``, and gets ``None``."""
    if groups is not None:
        groups = flatten_cluster_groups(groups)
        layout = groups.layout
    if n_clusters <= 1:
        return groups
    members, n_pods = layout
    intra, cross = rank_layout(len(members), n_pods, n_clusters)
    mine_intra = _new_groups([[members[r] for r in ranks] for ranks in intra])
    mine_cross = _new_groups([[members[r] for r in ranks] for ranks in cross])
    if groups is None:
        return None
    return replace(groups, n_clusters=int(n_clusters), intra=mine_intra,
                   cross=mine_cross)


def shrink_layout(layout: Layout, keep_pods: Sequence[int], *,
                  cluster: Optional[int] = None,
                  n_clusters: int = 1) -> Layout:
    """The survivors' layout (``shrink_mesh``'s row selection), on any
    process: ``keep_pods`` indexes the pod rows of ``layout``, or with
    ``cluster=c`` the pods within cluster ``c`` of ``n_clusters`` (every
    other cluster keeps all of its pods; the result is flat, cluster-major).
    A rank keeps all of its rows or none: a rank that holds several pods
    and loses only some of them raises, since the survivors' rows would no
    longer split evenly over the ranks.  The ranks stay in group order, so
    ``keep_pods`` must ascend."""
    members, n_pods = tuple(layout[0]), int(layout[1])
    keep = [int(k) for k in keep_pods]
    if not keep:
        raise ValueError("cannot shrink a pod group to zero pods")
    if cluster is not None:
        if n_clusters <= 1:
            raise ValueError("cluster= only applies to a cluster layout")
        ppc = n_pods // n_clusters
        if not 0 <= cluster < n_clusters:
            raise ValueError(f"cluster {cluster} of {n_clusters}")
        if any(not 0 <= p < ppc for p in keep):
            raise ValueError(f"pods {keep} out of range for a cluster of "
                             f"{ppc}")
        keep = [c * ppc + p for c in range(n_clusters)
                for p in (keep if c == cluster else range(ppc))]
    if keep != sorted(set(keep)) or not 0 <= keep[0] <= keep[-1] < n_pods:
        raise ValueError(f"keep_pods {keep} must ascend within the "
                         f"{n_pods} pod rows: the placed pod order is the "
                         f"members' ascending global ranks")
    rpr = n_pods // len(members)
    kept = sorted({k // rpr for k in keep})
    partial = [r for r in kept
               if any(r * rpr + i not in keep for i in range(rpr))]
    if partial:
        raise ValueError(
            f"ranks {[members[r] for r in partial]} would keep only some of "
            f"their {rpr} pods: the port places whole pods on each rank (the "
            f"reference gives each pod its own devices), and the survivors' "
            f"rows must split evenly over the ranks")
    return tuple(members[r] for r in kept), len(keep)


def shrink_groups(groups: Optional[PodGroups], keep_pods: Sequence[int], *,
                  cluster: Optional[int] = None,
                  layout: Optional[Layout] = None) -> Optional[PodGroups]:
    """The survivors' pod group (``shrink_mesh``): the ranks holding the
    kept pod rows, flat and cluster-major (:func:`shrink_layout`), each
    keeping its rows, so no buffer moves.  Collective over the default
    group (the module docstring); returns ``None`` on a rank whose every
    row died, which then issues no collective of the survivors' groups.
    A process already outside the group passes ``groups=None`` and its
    ``layout``."""
    n_clusters = 1
    if groups is not None:
        layout, n_clusters = groups.layout, groups.n_clusters
    return _pod_group(shrink_layout(layout, keep_pods, cluster=cluster,
                                    n_clusters=n_clusters))


def grow_layout(layout: Layout, n_new: int = 1, *,
                new_ranks: Optional[Sequence[int]] = None) -> Layout:
    """The regrown layout (``grow_mesh``'s row append), on any process:
    ``n_new`` ranks append their rows (as many as an incumbent holds) at
    the END of the pod order.  By default they are the first ranks of the
    default group outside ``layout``, after a shrink the dropped ones (the
    reference's first free devices).  ``dist.new_group`` orders a group by
    global rank, so the append is exact only when every newcomer's rank is
    above every incumbent's; otherwise this raises, as the reference leaves
    the row -> cluster permutation to the caller there."""
    members, n_pods = tuple(layout[0]), int(layout[1])
    if n_new < 1:
        raise ValueError(f"n_new {n_new}")
    if new_ranks is None:
        pool = [r for r in range(dist.get_world_size()) if r not in members]
    else:
        pool = [int(r) for r in new_ranks]
    if len(pool) < n_new:
        raise ValueError(f"growing by {n_new} rank(s) needs {n_new} free "
                         f"ranks, have {len(pool)}")
    new = pool[:n_new]
    if len(set(new)) != n_new or set(new) & set(members) \
            or min(new) <= max(members):
        raise ValueError(
            f"newcomers {new} must be new ranks above every incumbent "
            f"{members}: the pod group orders its ranks ascending, so only "
            f"then do their rows land at the end of the pod order")
    rpr = n_pods // len(members)
    return members + tuple(sorted(new)), n_pods + n_new * rpr


def grow_groups(groups: Optional[PodGroups], n_new: int = 1, *,
                new_ranks: Optional[Sequence[int]] = None,
                n_clusters: Optional[int] = None,
                layout: Optional[Layout] = None) -> Optional[PodGroups]:
    """The regrown pod group (``grow_mesh``, :func:`grow_layout`), regrouped
    into ``n_clusters`` tiers when given: the round trip shrink(the last
    pod of the last cluster) -> grow(n_clusters=C) gives back the original
    groups.  Collective over the default group (the module docstring); a
    newcomer passes ``groups=None`` and the incumbents' ``layout``.
    Returns ``None`` on a process in neither."""
    if groups is not None:
        layout = groups.layout
    grown = grow_layout(layout, n_new, new_ranks=new_ranks)
    flat = _pod_group(grown)
    if n_clusters is not None and n_clusters > 1:
        return regroup_groups(flat, n_clusters, layout=grown)
    return flat


def placed(groups: Optional[PodGroups]) -> bool:
    """Does a round over ``groups`` cross processes at all?"""
    return groups is not None and groups.size > 1


# -- production mesh shapes and per-architecture rules ----------------------

def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh as a shape: ``(16, 16)`` over
    ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` (its ``make_pod_mesh(2)`` at 512 devices too)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def mesh_axis_size(mesh: MeshShape, name: str) -> int:
    return mesh.axis_size(name)


def arch_parallel_config(arch: str, optimized: bool = False
                         ) -> ParallelConfig:
    """The parallelism policy of an assigned architecture: FSDP for the
    three largest, and with ``optimized`` the reference's gradient
    accumulation for the HBM-heaviest."""
    fsdp = arch in ("grok-1-314b", "granite-34b", "llava-next-34b")
    mb = 1
    if optimized:
        mb = {"grok-1-314b": 4, "llava-next-34b": 2, "granite-34b": 2,
              "deepseek-v2-lite-16b": 2, "recurrentgemma-2b": 4}.get(arch, 1)
    return ParallelConfig(fsdp=fsdp, microbatch=mb)


def arch_rules(cfg: ModelConfig, mesh: Optional[MeshShape],
               parallel: ParallelConfig, *, multi_pod: bool = False,
               decode: bool = False, batch: int = 0,
               tp_pad_heads: bool = False) -> AxisRules:
    """Divisibility-aware logical-to-mesh rules for one (arch, mesh,
    mode): a logical axis takes "model" only where its dimension divides
    by the model axis (16 with no mesh), the batch takes the replica tiers
    first (cluster, then pod) and "data" last where each divides it, and
    decode shards an MQA cache's sequence over "model"."""
    tp = mesh_axis_size(mesh, "model") if mesh is not None else 16
    dp = mesh_axis_size(mesh, "data") if mesh is not None else 16
    pods = mesh_axis_size(mesh, "pod") if (mesh is not None
                                           and multi_pod) else 1
    clusters = (mesh_axis_size(mesh, "cluster")
                if (mesh is not None and multi_pod) else 1)

    def div(n: int) -> bool:
        return n > 0 and n % tp == 0

    extra: Dict[str, object] = {}
    # heads shard only when divisible; tp_pad_heads pads the activation
    # heads so act_heads can shard where the parameter heads cannot
    extra["heads"] = "model" if div(cfg.num_heads) else None
    extra["act_heads"] = ("model" if (div(cfg.num_heads) or tp_pad_heads)
                          else None)
    extra["kv_heads"] = "model" if div(cfg.num_kv_heads) else None
    extra["act_kv"] = "model" if div(cfg.num_kv_heads) else None
    extra["vocab"] = "model" if div(cfg.vocab_size) else None
    extra["act_vocab"] = "model" if div(cfg.vocab_size) else None
    extra["ff"] = "model" if div(cfg.d_ff) else None
    extra["act_ff"] = "model" if div(cfg.d_ff) else None
    if cfg.recurrent is not None:
        w = cfg.recurrent.lru_width or cfg.d_model
        extra["lru"] = "model" if div(w) else None
    if cfg.moe is not None:
        if parallel.expert_parallel and div(cfg.moe.num_experts):
            extra["expert"] = "model"
            extra["expert_ff"] = None
        else:  # too few experts for expert parallelism: TP in each expert
            extra["expert"] = None
            extra["expert_ff"] = "model" if div(cfg.moe.expert_ff) else None

    # the batch: the replica tiers claim first, data last, each only where
    # it divides the global batch
    batch_axes = []
    if multi_pod and clusters > 1 and batch % clusters == 0:
        batch_axes.append("cluster")
    rep = clusters if "cluster" in batch_axes else 1
    if multi_pod and pods > 1 and (batch // rep) % pods == 0:
        batch_axes.append("pod")
        rep *= pods
    eff = batch // rep
    if batch % (rep * dp) == 0 and eff >= dp:
        batch_axes.append("data")
    extra["batch"] = tuple(batch_axes) if batch_axes else None
    extra["moe_group"] = extra["batch"]

    if decode:
        # an MQA cache shards its sequence over "model", bounding the
        # cache a device holds
        extra["cache_seq"] = "model" if not div(cfg.num_kv_heads) else None
        extra["seq"] = None  # one-token activations: no sequence parallel
    else:
        extra["cache_seq"] = None

    if parallel.fsdp:
        # with the batch off "data" (small serve batches), FSDP over the
        # idle data axis still holds: pure weight sharding
        extra.setdefault("embed", "data")
        extra.setdefault("qkv", "data")

    return make_rules(mesh, fsdp=parallel.fsdp,
                      sequence_parallel=(parallel.sequence_parallel
                                         and not decode),
                      multi_pod=multi_pod, extra=extra)
