"""``launch.hermes_dryrun`` on the CPU: (a) qwen3-8b's bills at full width
and depth on meta tensors against the reference's ``payload_bytes`` on
its ``abstract_init_lm``, the sharding hint moving no leaf's blocked
axis; (b) the round of qwen3-8b's smoke config in bf16 placed on two
spawned gloo ranks (one spawn for the module) against the unplaced run,
every format held to the collective-placement rule."""
import pytest
import jax

from repro.configs import get_config as jget_config
from repro.dist import compression as jcomp
from repro.launch.steps import abstract_init_lm as jabstract

import torch_parity  # noqa: F401  (one torch thread)

from repro_torch.dist import wire
from repro_torch.launch import hermes_dryrun as H

FORMATS = wire.available_formats()


@pytest.fixture(scope="module")
def bills():
    return H.full_width_bills("qwen3-8b")


@pytest.fixture(scope="module")
def executed(tmp_path_factory):
    return H.executed("qwen3-8b", smoke=True, device="cpu",
                      workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("fmt", FORMATS)
def test_full_depth_bills_equal_reference(bills, fmt):
    shapes, _ = jabstract(jget_config("qwen3-8b"), jax.random.PRNGKey(0))
    got = bills["formats"][fmt]
    assert got["billed_bytes"] == jcomp.payload_bytes(shapes, fmt)
    assert got["wire_spec_bytes"] == (got["billed_bytes"] // 2
                                      if fmt == "none"
                                      else got["billed_bytes"])
    assert bills["block_axis_hint_drift"] == 0
    assert bills["mesh"] == {"axes": ["pod", "data", "model"],
                             "shape": [2, 16, 16]}
    if fmt == "int4":
        assert got["bytes_per_element"] <= H.INT4_BOUND


@pytest.mark.parametrize("fmt", FORMATS)
def test_smoke_round_placed_on_two_ranks(executed, fmt):
    got = executed["formats"][fmt]
    assert executed["config"] == "smoke" and executed["dtype"] == "bfloat16"
    assert got["flat"]["bit_identical"] and got["closed"]["bit_identical"]
    flat = got["flat"]["collectives"]["flat_round"]
    assert flat["gather_bytes"] == got["shipped_bill"]
    assert got["shipped_bill"] == (got["payload_bytes"] // 2
                                   if fmt == "none" else got["payload_bytes"])
    for pin in got["closed"]["collectives"].values():
        assert pin["gather_bytes"] == 0 and pin["control_bytes"] == 8


def test_shipped_bill_is_payload_bytes_but_for_none():
    import torch
    tree = {"a": torch.empty((3, 512), dtype=torch.bfloat16, device="meta")}
    assert H.shipped_bill(tree, "none") == 3 * 512 * 2
    assert H.shipped_bill(tree, "fp16") == 3 * 512 * 2
    assert H.shipped_bill(tree, "int8") == 3 * 512 + 3 * 2 * 4
