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

``shrink_mesh`` and ``grow_mesh`` wait for the elastic launcher;
``make_production_mesh`` and the per-architecture rules for the model
zoo and the audits (ROADMAP queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

import torch.distributed as dist


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


@dataclass(frozen=True)
class PodGroups:
    """One rank's view of a placed run: the pod group (``size`` ranks,
    this one ``rank``), its pod rows, and with clusters the two tiers'
    groups it belongs to (``None`` when flat)."""

    n_pods: int
    rank: int
    size: int
    pod: Any
    n_clusters: int = 1
    intra: Any = None
    cross: Any = None

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


def regroup_groups(groups: PodGroups, n_clusters: int) -> PodGroups:
    """Inverse of :func:`flatten_cluster_groups` (``regroup_mesh``): split
    a flat pod group cluster-major into ``n_clusters`` tiers.  Collective:
    every rank creates every intra- and cross-cluster group, in the same
    order, and keeps its own."""
    groups = flatten_cluster_groups(groups)
    if n_clusters <= 1:
        return groups
    intra, cross = rank_layout(groups.size, groups.n_pods, n_clusters)
    mine_intra = mine_cross = None
    for ranks in intra:
        g = dist.new_group(ranks)
        if groups.rank in ranks:
            mine_intra = g
    for ranks in cross:
        g = dist.new_group(ranks)
        if groups.rank in ranks:
            mine_cross = g
    return replace(groups, n_clusters=int(n_clusters), intra=mine_intra,
                   cross=mine_cross)


def placed(groups: Optional[PodGroups]) -> bool:
    """Does a round over ``groups`` cross processes at all?"""
    return groups is not None and groups.size > 1
