"""``launch.round_audit`` on the CPU: the reference's round tree placed on
two spawned gloo ranks, every wire format's open round, dispatch + commit
and closed round bitwise the unplaced ones and held to the
collective-placement rule (one spawn for the module), and the pipelined
rounds' staleness parity."""
import pytest

import torch_parity  # noqa: F401  (one torch thread)

from repro_torch.dist import wire
from repro_torch.dist.compression import payload_bytes
from repro_torch.launch import round_audit as R

FORMATS = wire.available_formats()


@pytest.fixture(scope="module")
def audited(tmp_path_factory):
    return R.audit_rounds(FORMATS, device="cpu", resize=False,
                          workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("fmt", FORMATS)
def test_placed_rounds_bitwise_and_pinned(audited, fmt):
    got = audited["formats"][fmt]
    bill = payload_bytes(R._tree(), fmt)
    assert got["billed_bytes"] == bill
    for case, phase in (("flat", "flat_round"), ("flat_async", "dispatch")):
        assert got[case]["bit_identical"]
        pin = got[case]["collectives"][phase]
        assert pin["gather_bytes"] == bill and pin["control_bytes"] == 8
        if fmt == "int4":
            assert got[case]["bytes_per_element"] <= R.INT4_BOUND
    assert got["flat_async"]["collectives"]["commit"]["cross_pod_collectives"] \
        == 0
    closed = got["closed"]
    assert closed["merged"] == [False, False]
    for pin in closed["collectives"].values():
        assert pin["gather_bytes"] == 0 and pin["control_bytes"] == 8
        assert pin["cross_pod_collectives"] == 1


@pytest.mark.parametrize("fmt", FORMATS)
def test_async_parity_accounts_every_dispatch(fmt):
    got = R.async_parity(fmt, device="cpu")
    assert got["dispatched"] == got["committed"] == got["open_rounds"] > 0
    assert got["final_wg_max_abs_diff"] <= got["tolerance"]
