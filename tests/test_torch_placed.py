"""Placed Hermes rounds on four gloo ranks of the CPU against the unplaced
rounds (``repro_torch.launch.placed_audit``).

One module-scoped audit spawns the ranks once (a ``FileStore`` under
``tmp_path``, no port) and runs every case; each assert below reads one
case of its report.  Per wire format: the flat round, its async dispatch
+ commit, the two-tier round (2 clusters x 2 pods) and its async halves,
each bitwise the unplaced one on every rank (``w_global``, the rank's pod
rows and error rows, by SHA-256); every collective exactly one of
``dist.wire``'s specs, in order and on its tier; a closed round only the
gate exchange and a commit nothing; the host's ``merged`` flag the same
on every rank.  Then the placed lmtiny trainer, 4 pods in 2 clusters on
2 ranks, against the unplaced one.
"""
import pytest
import torch

from repro_torch.dist import wire
from repro_torch.launch import placed_audit

FORMATS = wire.available_formats()
KEYS = [f"{f}/{c}" for f in FORMATS for c in placed_audit.CASES]
TRAIN = {"int4-sync": dict(compression="int4", async_rounds=False),
         "int8-async": dict(compression="int8", async_rounds=True)}


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    return placed_audit.audit(
        "toy", ranks=4, n_pods=4, n_clusters=2, device="cpu",
        workdir=str(tmp_path_factory.mktemp("placed")))["cases"]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    out = {}
    for name, kw in TRAIN.items():
        train = dict(steps=8, batch=4, seq=32, lr=3e-3, **kw)
        out[name] = placed_audit.audit(
            "lmtiny", ranks=2, n_pods=4, n_clusters=2, formats=(), cases=(),
            train=train, device="cpu",
            workdir=str(tmp_path_factory.mktemp("train")))["train"]
    return out


@pytest.mark.parametrize("key", KEYS)
def test_placed_case_bitwise_equal_to_unplaced(rounds, key):
    assert rounds[key]["equal"], key


@pytest.mark.parametrize("key", KEYS)
def test_placed_gathers_are_the_wire_specs(rounds, key):
    """Each rank's collectives, phase by phase: the gate exchange, then
    exactly ``wire_operand_specs`` (flat, or the fast tier) and
    ``cluster_wire_operand_specs`` (the slow tier), in order."""
    case = rounds[key]
    for rank, got in enumerate(case["collectives"]):
        assert got == case["expected"], (key, rank)


@pytest.mark.parametrize("key", KEYS)
def test_merged_flag_same_on_every_rank(rounds, key):
    """``bool(any_push)``, read on the host, is one value on every rank
    and the unplaced round's: every rank issues the same collectives."""
    case = rounds[key]
    assert all(m == case["unplaced_merged"] for m in case["merged"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_closed_rounds_and_commits_move_no_payload(rounds, fmt):
    closed = rounds[f"{fmt}/closed"]
    dtype, dims, nbytes = wire.control_operand_spec(1)
    ctl = [["pod", dtype, list(dims), nbytes]]
    assert closed["unplaced_merged"] == [False, False]
    for got in closed["collectives"]:
        assert got == {"flat_round": ctl, "cluster_round": ctl}
    for case in ("flat_async", "cluster_async"):
        for got in rounds[f"{fmt}/{case}"]["collectives"]:
            assert got["commit"] == []
            assert len(got["dispatch"]) > 1


def test_two_tier_slow_tier_is_half_the_flat_wire(rounds):
    """2 clusters of 2 pods: the slow tier ships one row a cluster, so a
    rank moves as many slow-tier bytes as fast-tier payload bytes."""
    got = rounds["int4/cluster"]["collectives"][0]["cluster_round"]
    fast = sum(b for tier, *_, b in got if tier == "intra")
    slow = sum(b for tier, *_, b in got if tier == "cluster")
    assert fast > 0 and slow == fast
    meta = {k: torch.empty(s, device="meta")
            for k, s in placed_audit.TOY.items()}
    assert slow == sum(b for *_, b in wire.cluster_wire_operand_specs(
        meta, "int4", 2, n_pods=4))


@pytest.mark.parametrize("name", TRAIN)
def test_placed_trainer_equals_unplaced(trainers, name):
    """Two ranks of two pods each, the global pod ids' data shards: the
    same gate history, merges, losses and async accounting as the
    unplaced run, bit for bit (one thread count on both sides)."""
    want = trainers[name]["unplaced"]
    assert 0 < want["merges"] < want["rounds"]
    for got in trainers[name]["placed"]:
        for k in ("history", "merges", "rounds", "global_loss",
                  "pod_losses", "dispatched", "committed", "drained"):
            assert got[k] == want[k], (name, k)
