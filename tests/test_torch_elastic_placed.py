"""Elastic membership placed on gloo ranks of the CPU
(``repro_torch.launch.placed_audit``'s elastic cases), and the pod-group
layouts of ``repro_torch.launch.mesh`` that a resize builds.

One module-scoped audit spawns four ranks once
(``launch.spawn.spawn_ranks``: a ``FileStore`` under ``tmp_path``, no
port; a rank that fails fails the audit with its traceback) and runs ``drop``, ``rejoin`` and
``cluster_resize`` for ``none`` and ``int8``, the formats the reference
pins resize-invariant.  The parent runs the never-resized oracle (every
row kept, the dead stretch live-masked, the dead row re-seeded at the
grow); each rank runs the resize and must hash every row it holds, under
its original pod id, as the oracle does.  Every collective of every step
is held to its spec at the current pod count.  A second spawn of six
ranks regroups a pod group over the global ranks ``[0, 1, 4, 5]`` (the
survivors of a 3-cluster group that lost cluster 1): each tier must hold
the right processes by global rank.  The audit's ranks also run the
drop and rejoin proofs of ``launch.elastic`` placed, each rank checking
its own rows.
"""
import pytest
import torch

from repro_torch.launch import mesh, placed_audit

import torch_parity  # noqa: F401  (one torch thread)

FORMATS = ("none", "int8")
KEYS = [f"{f}/{c}" for f in FORMATS for c in placed_audit.ELASTIC]
SURVIVORS = {"drop": [[0], [], [2], [3]], "rejoin": [[0], [1], [2], [3]],
             "cluster_resize": [[0], [1], [2], [3]]}


@pytest.fixture(scope="module")
def audit(tmp_path_factory):
    return placed_audit.audit(
        "toy", ranks=4, n_pods=4, n_clusters=2, formats=FORMATS, cases=(),
        elastic=placed_audit.ELASTIC, device="cpu",
        workdir=str(tmp_path_factory.mktemp("elastic")))


@pytest.fixture(scope="module")
def elastic(audit):
    return audit["elastic"]


@pytest.mark.parametrize("key", KEYS)
def test_resized_rows_bitwise_the_never_resized_run(elastic, key):
    """Every row a rank holds at the end (``w_global``, pod params, error,
    gate state), under its original pod id, hashes as the oracle's; the
    dead rank of ``drop`` holds none, every other pod is held once."""
    case = elastic[key]
    assert case["equal"], (key, case["equal_per_rank"])
    assert case["rows"] == SURVIVORS[key.split("/")[1]]


@pytest.mark.parametrize("key", KEYS)
def test_elastic_collectives_are_the_specs(elastic, key):
    """Each rank, step by step: a round gathers the gate exchange and, if
    it merged, ``wire_operand_specs`` (or the two tiers') at the CURRENT
    pod count (4, then 3, then 4); the shrink nothing, its flush commit
    included; the grow one broadcast of the unstacked tree; a rank
    outside the group nothing."""
    case = elastic[key]
    for rank, got in enumerate(case["collectives"]):
        assert got == case["expected"][rank], (key, rank)


@pytest.mark.parametrize("key", KEYS)
def test_every_rank_merges_as_the_oracle(elastic, key):
    """The host's ``merged`` flag of every round a rank ran is the
    oracle's; a rank runs every round but those outside the group, and
    the resized stretches merge (the proofs are not vacuous)."""
    case = elastic[key]
    want = case["unplaced_merged"]
    for rank, got in enumerate(case["merged"]):
        assert all(want[r] == m for r, m in got.items()), (key, rank)
    out = {"drop": {1: ["r5", "r6", "r7"]},
           "rejoin": {3: ["r4", "r5"]},
           "cluster_resize": {3: ["r5", "r6"]}}[key.split("/")[1]]
    for rank, got in enumerate(case["merged"]):
        assert set(got) == set(want) - set(out.get(rank, [])), (key, rank)
    assert sum(want.values()) >= 5, want


@pytest.mark.parametrize("fmt", FORMATS)
def test_dead_rank_issues_nothing_after_the_shrink(elastic, fmt):
    phases = elastic[f"{fmt}/drop"]["collectives"][1]
    after = list(phases)[list(phases).index("shrink"):]
    assert after and all(phases[p] == [] for p in after)
    for got in elastic[f"{fmt}/drop"]["collectives"]:
        assert got["shrink"] == []       # the flush commit gathers nothing
    assert elastic[f"{fmt}/drop"]["unplaced_merged"]["r4"]  # it had a push


@pytest.mark.parametrize("fmt", FORMATS)
def test_grow_broadcasts_the_unstacked_tree_once(elastic, fmt):
    nbytes = 4 * sum(torch.Size(s).numel() for s in placed_audit.TOY.values())
    for case in ("rejoin", "cluster_resize"):
        for got in elastic[f"{fmt}/{case}"]["collectives"]:
            assert got["grow"] == [["pod/broadcast", "uint8", [nbytes],
                                    nbytes]]


@pytest.mark.parametrize("fmt", FORMATS)
def test_groups_after_each_resize(elastic, fmt):
    """The survivors' group by global rank (pod 1 dies: ``[0, 2, 3]``);
    the regrown group appends the dead rank at the end; shrink of cluster
    1's last pod then ``grow(n_clusters=2)`` gives back every tier."""
    for rank in range(4):
        assert elastic[f"{fmt}/drop"]["members"][rank] == \
            {"shrink": [0, 2, 3]}
        for case in ("rejoin", "cluster_resize"):
            assert elastic[f"{fmt}/{case}"]["members"][rank] == \
                {"shrink": [0, 1, 2], "grow": [0, 1, 2, 3]}
        tiers = elastic[f"{fmt}/cluster_resize"]["tiers"][rank]
        assert tiers["grown"] == tiers["start"]
        assert tiers["start"]["intra"] == [[0, 1], [2, 3]][rank // 2]
        assert tiers["start"]["cluster"] == [[0, 2], [1, 3]][rank % 2]


def test_cross_cluster_shrink_refused(elastic):
    """The failure domain is cluster-local: a ``cluster=1`` shrink that
    also drops a pod of cluster 0 raises on every rank, before any
    collective (the reference's ``_PLACED_SCRIPT``)."""
    for fmt in FORMATS:
        assert elastic[f"{fmt}/cluster_resize"]["cross_cluster_refused"] == \
            [True] * 4


def test_regroup_of_survivors_names_global_ranks(tmp_path):
    """Six ranks; the pod group is global ranks ``[0, 1, 4, 5]``; regrouped
    into 2 clusters, cluster 0 is ``[0, 1]``, cluster 1 ``[4, 5]``, and
    the slow tier joins ``[0, 4]`` and ``[1, 5]``: a gather over each tier
    meets exactly those processes.  Ranks 2 and 3 create the groups and
    hold none."""
    reports = placed_audit.regroup_audit([0, 1, 4, 5], 6, 2,
                                         workdir=str(tmp_path))
    assert [r["member"] for r in reports] == [True, True, False, False,
                                              True, True]
    want = {0: (0, [0, 1], [0, 4]), 1: (1, [0, 1], [1, 5]),
            4: (2, [4, 5], [0, 4]), 5: (3, [4, 5], [1, 5])}
    for r in reports:
        if not r["member"]:
            continue
        group_rank, intra, cross = want[r["rank"]]
        assert r["group_rank"] == group_rank
        assert r["rows"] == [group_rank, group_rank + 1]
        assert r["cluster"] == group_rank // 2
        assert r["tiers"] == {"pod": [0, 1, 4, 5], "intra": intra,
                              "cluster": cross}
        assert r["met"] == {"pod": [0, 1, 4, 5], "intra": intra,
                            "cluster": cross}


@pytest.mark.parametrize("compression", FORMATS)
def test_proofs_hold_placed(audit, compression):
    """``drop_pod_equivalence`` (pod 1) and ``rejoin_pod_equivalence``
    (pod 3) with ``groups``, on the audit's ranks: every rank runs both
    paths on its own rows and holds them bitwise (a rank that fails fails
    the audit); the dead rank leaves the survivors' group and, in the
    rejoin, comes back."""
    reports = audit["proofs"][compression]
    assert len(reports) == 4
    for rank, r in enumerate(reports):
        drop, rejoin = r["drop"], r["rejoin"]
        assert drop["bit_identical"] and rejoin["bit_identical"]
        assert not rejoin["warmup_checked"]   # path C runs unplaced only
        assert (drop["group"], drop["survivor_group"]) == \
            (4, None if rank == 1 else 3)
        assert (rejoin["shrunk_group"], rejoin["regrown_group"]) == \
            (None if rank == 3 else 3, 4)


def test_a_failing_rank_fails_the_spawn_with_its_traceback(tmp_path):
    """``launch.spawn.spawn_ranks``, which every audit spawns through: a
    rank that raises makes the spawn raise with that rank's traceback, not
    only its exit code, and the ranks waiting on it are stopped."""
    from repro_torch.launch.spawn import spawn_ranks
    import torch_ranks
    with pytest.raises(RuntimeError) as e:
        spawn_ranks(4, {"rank": 2}, torch_ranks.fails_on_rank, timeout=120,
                    workdir=str(tmp_path))
    text = str(e.value)
    assert "--- rank 2 raised:" in text and "Traceback" in text
    assert "ValueError: rank 2 fails on purpose" in text
    assert "fails_on_rank" in text          # the frame that raised
    assert list(tmp_path.iterdir()) == []   # its directory is removed
    ok = spawn_ranks(4, {"rank": -1}, torch_ranks.fails_on_rank, timeout=120,
                     workdir=str(tmp_path))
    assert [r["rank"] for r in ok] == [0, 1, 2, 3]


def test_layouts_of_a_resize():
    """The pure halves of ``shrink_groups`` / ``grow_groups``: rows and
    ranks as ``shrink_mesh`` / ``grow_mesh`` place them, and the
    refusals."""
    four = ((0, 1, 2, 3), 4)
    assert mesh.shrink_layout(four, [0, 2, 3]) == ((0, 2, 3), 3)
    # cluster-local: keep_pods index pods within the cluster; the result
    # is flat, cluster-major
    assert mesh.shrink_layout(four, [0], cluster=1, n_clusters=2) == \
        ((0, 1, 2), 3)
    assert mesh.shrink_layout(four, [1], cluster=0, n_clusters=2) == \
        ((1, 2, 3), 3)
    # two pods a rank: a rank keeps both rows or none
    assert mesh.shrink_layout(((0, 1), 4), [2, 3]) == ((1,), 2)
    with pytest.raises(ValueError, match="whole pods"):
        mesh.shrink_layout(((0, 1), 4), [0, 2, 3])
    with pytest.raises(ValueError, match="ascend"):
        mesh.shrink_layout(four, [2, 0])
    with pytest.raises(ValueError, match="cluster layout"):
        mesh.shrink_layout(four, [0], cluster=1)
    with pytest.raises(ValueError, match="zero pods"):
        mesh.shrink_layout(four, [])
    assert mesh.grow_layout(((0, 1, 2), 3), new_ranks=[3]) == four
    assert mesh.grow_layout(((0, 1), 4), new_ranks=[5]) == ((0, 1, 5), 6)
    with pytest.raises(ValueError, match="above every incumbent"):
        mesh.grow_layout(((0, 2, 3), 3), new_ranks=[1])
    with pytest.raises(ValueError, match="free ranks"):
        mesh.grow_layout(four, 2, new_ranks=[4])
    with pytest.raises(ValueError, match="ascending"):
        mesh.PodGroups(n_pods=3, rank=0, size=3, pod=None, members=(2, 0, 1))
