"""The collective-placement rule (``analysis.collectives``) and the
analyzer's round targets (``launch.analyze``), on the CPU.

Each of the rule's five named classes is raised by a fixture of counted
records; then the analyzer's targets run once on two spawned gloo ranks
(one pod a rank, a ``FileStore`` in a temporary directory) and each is
held to the rule in this process, as ``python -m
repro_torch.launch.analyze`` holds them.
"""
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)

from repro_torch.analysis import (
    Aliasing, AnalysisError, CollectivePlacement, DonationAliasing, analyze,
    classify_collectives, control_traffic_allowance,
)
from repro_torch.analysis import collectives as C
from repro_torch.dist import wire
from repro_torch.dist.compression import payload_bytes
from repro_torch.launch import analyze as A

N = 2
TREE = {"w": torch.empty((4, 512), device="meta"),
        "b": torch.empty((7,), device="meta")}


def _record(spec, kind="all_gather_into_tensor", tier="pod", size=N, i=0):
    dtype, dims, nbytes = spec
    return {"kind": kind, "name": f"{kind}#{i}", "tier": tier,
            "group_size": size,
            "operands": [{"dtype": dtype, "dims": list(dims),
                          "bytes": nbytes}]}


def _ship(mode, specs=None):
    """The records of a clean placed ship: the gate exchange, then every
    wire operand once."""
    specs = wire.wire_operand_specs(TREE, mode, N) if specs is None else specs
    return [_record(wire.control_operand_spec(1))] + \
        [_record(s, i=i + 1) for i, s in enumerate(specs)]


def _classes(rule, recs):
    with pytest.raises(AnalysisError) as e:
        analyze([rule], collectives=recs, label="fixture")
    return {v.cls for v in e.value.violations}


@pytest.mark.parametrize("mode", wire.available_formats())
def test_a_clean_ship_passes_and_matches_the_bill(mode):
    rule = C.placement_rule(TREE, mode, N)
    analyze([rule], collectives=_ship(mode), label=mode)
    cls = rule.classification
    assert cls["payload_bytes"] == payload_bytes(TREE, mode)
    assert cls["control_bytes"] == 8 and not cls["unexpected"]
    assert len(rule.records) == 1 + len(wire.wire_operand_specs(TREE, mode,
                                                                N))


def test_a_doubled_payload_is_an_unexpected_operand():
    recs = _ship("int8")
    big = max(recs, key=lambda r: r["operands"][0]["bytes"])
    recs.append(dict(big, name="again"))  # the largest payload ships twice
    assert "unexpected-cross-pod-operand" in _classes(
        C.placement_rule(TREE, "int8", N), recs)


def test_a_dropped_payload_is_a_missing_operand():
    recs = _ship("int4")
    del recs[2]
    assert _classes(C.placement_rule(TREE, "int4", N), recs) == \
        {"missing-wire-operand"}


def test_an_fp32_delta_is_an_fp32_model_crossing():
    recs = [_record(wire.control_operand_spec(1)),
            _record(("float32", (1, 4, 512), 8192), i=1),
            _record(("float32", (1, 7), 28), i=2)]
    got = _classes(C.placement_rule(TREE, "fp16", N), recs)
    assert "fp32-model-crossing" in got and "missing-wire-operand" in got


def test_a_gather_in_a_closed_round_is_an_unexpected_collective():
    closed = [_record(wire.control_operand_spec(1))]
    analyze([C.closed_rule(N)], collectives=closed, label="closed")
    forced = closed + [_record(wire.wire_operand_specs(TREE, "int8", N)[-2],
                               i=1)]
    assert _classes(C.closed_rule(N), forced) == \
        {"unexpected-cross-pod-collective"}
    # a commit may not even exchange the gates
    assert _classes(C.pod_local_rule(N), closed) == \
        {"unexpected-cross-pod-collective"}


def test_a_bill_that_differs_from_the_wire_is_billing_drift():
    rule = CollectivePlacement(wire.wire_operand_specs(TREE, "int8", N),
                               n_pods=N,
                               billed_bytes=payload_bytes(TREE, "int8") + 4)
    assert _classes(rule, _ship("int8")) == {"billing-drift"}


def test_control_traffic_rows_and_tiers():
    """The allowance is 4 B a pod and 8 B of slack; a group of one or a
    tier outside the pod tiers crosses nothing; the two-tier mode bills
    each tier against its own specs."""
    assert control_traffic_allowance(2) == 16 == 4 * 2 + 8
    recs = [_record(("int8", (1, 4, 512), 2048), size=1),
            _record(("int8", (1, 4, 512), 2048), tier="other")]
    analyze([C.pod_local_rule(N)], collectives=recs, label="local")
    n, c = 4, 2
    fast = wire.wire_operand_specs(TREE, "int8", n, n_clusters=c)
    slow = wire.cluster_wire_operand_specs(TREE, "int8", c, n_pods=n)
    recs = [_record(s, tier="intra", i=i) for i, s in enumerate(fast)] + \
        [_record(s, tier="cluster", i=9 + i) for i, s in enumerate(slow)]
    bill = payload_bytes(TREE, "int8")
    rule = CollectivePlacement(fast, n_pods=n, billed_bytes=bill,
                               n_clusters=c, cluster_specs=slow,
                               cluster_billed_bytes=bill)
    analyze([rule], collectives=recs, label="two-tier")
    assert rule.classification["payload_bytes"] == bill == \
        rule.cluster_classification["payload_bytes"]
    # classify_round_collectives splits the tiers by the records' identity
    got = wire.classify_round_collectives(
        recs, fast, n_pods=n, n_clusters=c,
        cluster_records=[r for r in recs if r["tier"] == "cluster"],
        cluster_specs=slow)
    assert got["payload_bytes"] == bill == got["cluster"]["payload_bytes"]
    assert classify_collectives(recs[:len(fast)], fast)["unmatched_specs"] \
        == []


def test_count_collectives_logs_and_restores(tmp_path):
    """One gloo rank: every counted kind logs its operand and issues the
    real call; restoring puts the real functions back."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        real = dist.all_gather_into_tensor
        log = []
        restore = C.count_collectives(log)
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        out = torch.empty_like(x)
        dist.all_gather_into_tensor(out, x)
        dist.all_reduce(x)
        dist.broadcast(x, src=0)
        restore()
        assert dist.all_gather_into_tensor is real
        assert torch.equal(out, x)
        recs = C.records(log, None)
        assert [r["kind"] for r in recs] == ["all_gather_into_tensor",
                                             "all_reduce", "broadcast"]
        assert recs[0]["operands"] == [{"dtype": "float32", "dims": [2, 3],
                                        "bytes": 24}]
        assert all(r["tier"] == "pod" and r["group_size"] == 1
                   for r in recs)
        assert C.cross_pod(recs) == []
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def per_rank(tmp_path_factory):
    """Every round target, the train step and the fp32-hoist fixture, run
    once on two spawned gloo ranks."""
    return A.run_round_targets(device="cpu",
                               workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("check", ["check_hermes_round",
                                   "check_async_halves", "check_admission",
                                   "check_train_step"])
def test_analyzer_round_targets_clean_on_two_ranks(per_rank, check):
    """Each check clean on both ranks; the commit and the train step are
    held to the donation rule too."""
    reports = getattr(A, check)(per_rank)
    assert reports and all(r.ok for r in reports)
    for r in reports:
        donates = r.label.startswith(("hermes_commit", "train_step"))
        assert r.rules == ["collective-placement"] + (
            ["donation-aliasing"] if donates else []), r.label


def test_open_round_ships_the_bill_and_the_closed_one_the_gates(per_rank):
    mode = A._cfg().compression
    for recs in per_rank:
        rule = C.placement_rule(A._wire_tree(), mode, A.N_PODS)
        analyze([rule], collectives=recs[f"hermes_round[{mode}]"])
        assert rule.classification["payload_bytes"] == \
            payload_bytes(A._wire_tree(), mode)
        closed = recs[f"hermes_round_closed[{mode}]"]
        assert [r["operands"][0]["dims"] for r in closed] == [[1, 2]]
        assert recs[f"hermes_commit[{mode}]"] == []
        assert recs["train_step[qwen3-8b]"] == []
    labels = set(per_rank[0])
    assert {f"hermes_round[{mode},prate=0.5,{a}]" for a in ("topk", "prob")} \
        <= labels


def test_donation_halves_alias_on_two_ranks(per_rank):
    """Each rank's donation records: the commit's pods and the train
    step's whole state (every tensor leaf; the step counts are Python
    ints, without storage) come back in their own storage; a record whose
    outputs lost one donated storage raises ``dropped-donation``."""
    mode = A._cfg().compression
    for recs in per_rank:
        don = recs["donation"]
        assert set(don) == {f"hermes_commit[{mode}]", "train_step[qwen3-8b]"}
        assert don[f"hermes_commit[{mode}]"]["donated"] == \
            {"pod_params": [0, 2]}
        for label, rec in don.items():
            al = Aliasing.from_json(rec["aliasing"])
            (lo, hi), = rec["donated"].values()
            held = [p for p in al.inputs[lo:hi] if p is not None]
            assert held and set(held) <= al.outputs, label
            broken = Aliasing(al.inputs, al.outputs - {held[0]})
            rule = DonationAliasing({"x": range(lo, hi)})
            with pytest.raises(AnalysisError, match="dropped-donation"):
                analyze([rule], aliasing=broken, label=label)


def test_fp32_hoist_fixture_raises_its_class(per_rank):
    got = A.selftest_fp32_hoist(per_rank)
    assert got["raised"] and "fp32-model-crossing" in got["classes"]
