"""The port's static analyzer over its entry points (the reference's
``launch/analyze.py``, ``make lint-hlo``).

* ``check_round_loop_source``: the host-sync guard over the production
  round loop, ``launch.train.train_hermes``, with the one sanctioned
  fetcher ``_host_fetch`` allowed.
* ``check_kernels``: the kernel tile lint over the launch spec of every
  ported CUDA kernel (``kernels.ops.kernel_lint_cases``) and over the wire
  path's pack constants, Python against the CUDA sources.

``--self-test`` proves the analyzer fails loudly: it rebuilds one known
regression per ported rule class (a ``bool(any_push)`` per-round host
sync, a mis-tiled copy) and requires each to raise
:class:`repro_torch.analysis.AnalysisError` with its named violation.
The mis-tiled copy is a real CUDA kernel (``kernels/tile_copy.py``): on
the card the self-test also launches it and requires its output to equal
the plain version's bit for bit.

Not ported yet (ROADMAP queue 1): the collective-placement and donation
rules and their fixtures, and the HLO checks of the round, the async
halves, admission and the train step.  The elastic resize's check (the
reference's ``check_elastic``: after 4 -> 3 -> 4 pods the wire bill
tracks the pod count and nothing else crosses) is
``launch.placed_audit``'s elastic cases, on the collectives each rank
issues.

Usage:
    python -m repro_torch.launch.analyze --self-test [--out PATH]
    python -m repro_torch.launch.analyze --self-test --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import (
    AnalysisError, HostSyncGuard, KernelTileLint, Report, analyze,
)
from repro_torch.kernels import ops, tile_copy
from repro_torch.launch.train import train_hermes


def check_round_loop_source() -> List[Report]:
    """AST pass over the production round loop: every device-to-host read
    goes through the single allow-listed fetcher."""
    return [analyze([HostSyncGuard(allow=("_host_fetch",))],
                    fn=train_hermes, label="train_hermes[source]")]


def check_kernels() -> List[Report]:
    """Tile lint over every ported kernel's launch spec + the constants."""
    out = [analyze([KernelTileLint()], launches=[spec],
                   label=f"kernel[{label}]")
           for label, spec in ops.kernel_lint_cases()]
    out.append(analyze([KernelTileLint(check_constants=True)],
                       label="kernel[pack-constants]"))
    return out


# ---------------------------------------------------------------------------
# Self-test: prove each rule class fails loudly on a known regression
# ---------------------------------------------------------------------------

def _expect_violation(label: str, cls: str, thunk: Callable[[], Any]
                      ) -> Dict[str, Any]:
    try:
        thunk()
    except AnalysisError as e:
        classes = {v.cls for v in e.violations}
        if cls not in classes:
            raise AssertionError(f"{label}: expected violation class "
                                 f"{cls!r}, got {classes}") from e
        return {"fixture": label, "expected_class": cls, "raised": True,
                "classes": sorted(classes)}
    raise AssertionError(
        f"{label}: analyzer passed a fixture built to violate {cls!r}")


def selftest_host_sync_loop() -> Dict[str, Any]:
    """The reference's old bug shape: ``bool(any_push)`` once per round."""

    def bad_round_loop(state, steps):  # pragma: no cover - read by AST
        for i in range(steps):
            state, any_push = step(state)          # noqa: F821
            if bool(any_push):                     # per-round host sync
                log(i)                             # noqa: F821
        return state

    return _expect_violation(
        "host-sync-in-loop", "host-sync-in-loop",
        lambda: analyze([HostSyncGuard()], fn=bad_round_loop,
                        label="selftest[host-sync]"))


def selftest_bad_tiles(device: torch.device) -> Dict[str, Any]:
    """A copy whose tile neither divides the array nor fills whole
    128-byte segments: the lint must name ``tile-misaligned``.  On the
    card the kernel also runs, and must equal its plain version bit for
    bit (``copy_equal``; None on the CPU, where there is no kernel)."""
    out = _expect_violation(
        "bad-tiles", "tile-misaligned",
        lambda: analyze([KernelTileLint()],
                        launches=[tile_copy.launch_spec()],
                        label="selftest[bad-tiles]"))
    out["copy_equal"] = None
    if device.type == "cuda":
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            tile_copy.SHAPE).astype(np.float32)).to(device)
        if not torch.equal(tile_copy.tile_copy_cuda(x),
                           tile_copy.tile_copy_plain(x)):
            raise AssertionError("tile_copy differs from its plain version")
        out["copy_equal"] = True
    return out


def run_selftests(device: torch.device) -> List[Dict[str, Any]]:
    return [selftest_host_sync_loop(), selftest_bad_tiles(device)]


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--self-test", action="store_true",
                    help="also run the violating fixtures (each must fail "
                         "with its named violation class)")
    ap.add_argument("--device", default="cuda",
                    help="where the fixture's copy runs (default: the card)")
    ap.add_argument("--out", default=None, help="write a JSON report")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    reports = check_round_loop_source() + check_kernels()
    for r in reports:
        print(f"  ok {r.label} ({', '.join(r.rules)})")
    record: Dict[str, Any] = {
        "device": str(device),
        "targets": [r.to_json() for r in reports],
        "ok": all(r.ok for r in reports),
    }
    if args.self_test:
        record["self_test"] = run_selftests(device)
        for f in record["self_test"]:
            print(f"  ok self-test {f['fixture']} raised "
                  f"{f['expected_class']} ({', '.join(f['classes'])})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
        print(f"wrote {args.out}")
    print(f"analyzed {len(reports)} targets: all clean")
    return record


if __name__ == "__main__":
    main()
