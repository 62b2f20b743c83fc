"""``launch.hermes_dryrun``'s stand-in cases on the CPU, as its
``--drop-pod``, ``--rejoin-pod`` and ``--clusters 2`` run them: the
elastic drop and rejoin on four spawned gloo ranks, bitwise the
never-resized oracle, then the two-tier round at 4 pods in 2 clusters,
every format, held tier by tier to the collective-placement rule."""
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread)

from repro_torch.dist import wire
from repro_torch.dist.compression import payload_bytes
from repro_torch.launch import hermes_dryrun as H
from repro_torch.launch import placed_audit as pa


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    return H.stand_in(drop_pod=True, rejoin_pod=True, device="cpu",
                      workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    return H.stand_in(clusters=2, device="cpu",
                      workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("key", ["none/drop", "none/rejoin", "int8/drop",
                                 "int8/rejoin"])
def test_resize_stand_in_bitwise(elastic, key):
    got = elastic[key]
    assert got["bit_identical"]
    want = [[0], [], [2], [3]] if key.endswith("drop") else \
        [[0], [1], [2], [3]]
    assert got["rows"] == want


@pytest.mark.parametrize("fmt", wire.available_formats())
def test_two_tier_stand_in_held_tier_by_tier(clusters, fmt):
    """The fast tier ships the members' payloads, billed; the commit
    crosses nothing; a closed round only the gate exchange."""
    got = clusters["clusters"]
    assert (got["n_pods"], got["n_clusters"]) == (4, 2)
    tree = {k: torch.empty(s, device="meta") for k, s in pa.ROUND.items()}
    open_round = got["formats"][f"{fmt}/cluster"]["cluster_round"]
    assert open_round["gather_bytes"] == payload_bytes(tree, fmt)
    dispatch = got["formats"][f"{fmt}/cluster_async"]
    assert dispatch["commit"]["cross_pod_collectives"] == 0
    for pin in got["formats"][f"{fmt}/closed"].values():
        assert pin["gather_bytes"] == 0 and pin["control_bytes"] == 8
