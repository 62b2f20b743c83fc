"""The port's static analyzer over its entry points (the reference's
``launch/analyze.py``, ``make lint-hlo``).

The round targets run on ``N_PODS`` gloo ranks, one pod a rank, spawned
once for all of them (``launch.spawn.spawn_ranks``), on the
device asked for; each rank counts the collectives it issues
(``analysis.collectives.count_collectives``) and the parent holds each
target's records to the collective-placement rule:

* ``check_hermes_round``: the open round ships exactly the billed wire,
  each payload array once; the closed round ships only the gate exchange.
* ``check_async_halves``: the dispatch carries the gather; the commit
  (``launch.train.make_async_round_fns``'s, as ``train_hermes`` runs it)
  issues no collective and its donated ``pod_params`` come back in their
  own storage (``analysis.donation.DonationAliasing``).
* ``check_admission``: ``topk`` and ``prob`` admission at participation
  0.5, round and dispatch, against the unchanged wire specs.
* ``check_train_step``: qwen3-8b's smoke model's local train step through
  ``launch/steps.py`` issues no collective and updates its whole donated
  state in place.

Beside them:

* ``check_round_loop_source``: the host-sync guard over the production
  round loop, ``launch.train.train_hermes``, with the one sanctioned
  fetcher ``_host_fetch`` allowed.
* ``check_kernels``: the kernel tile lint over the launch spec of every
  ported CUDA kernel (``kernels.ops.kernel_lint_cases``) and over the wire
  path's pack constants, Python against the CUDA sources.

``--self-test`` proves the analyzer fails loudly: it rebuilds one known
regression per ported rule class (a ship that gathers the fp32 delta, a
functional commit that drops its donation, a ``bool(any_push)``
per-round host sync, a mis-tiled copy) and requires
each to raise :class:`repro_torch.analysis.AnalysisError` with its named
violation.  The mis-tiled copy is a real CUDA kernel
(``kernels/tile_copy.py``): on the card the self-test also launches it
and requires its output to equal the plain version's bit for bit.  The
elastic resize's check (the reference's ``check_elastic``) is
``launch.placed_audit``'s elastic cases.

Usage:
    python -m repro_torch.launch.analyze --self-test [--out PATH]
    python -m repro_torch.launch.analyze --self-test --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import (
    Aliasing, AnalysisError, DonationAliasing, HostSyncGuard,
    KernelTileLint, Report, analyze, donated_leaf_ranges, trace_aliasing,
)
from repro_torch.analysis import collectives as C
from repro_torch.config import (
    HermesConfig, OptimizerConfig, ParallelConfig, ShapeConfig,
)
from repro_torch.kernels import ops, tile_copy
from repro_torch.launch.spawn import spawn_ranks
from repro_torch.launch.train import make_async_round_fns, train_hermes
from repro_torch.utils.trees import tree_map

N_PODS = 2          # the round, dispatch, commit and train targets


def _cfg(mode: Optional[str] = None, **kw) -> HermesConfig:
    mode = {} if mode is None else {"compression": mode}
    return HermesConfig(alpha=-0.3, beta=0.1, lam=2, window=4, **mode, **kw)


def _toy(dev: torch.device, n: int = N_PODS):
    """The reference's round tree: one blocked leaf and one short tail,
    ``(pods, w_global)``, drawn with numpy from seed 0."""
    rng = np.random.default_rng(0)
    pods = {"w": rng.standard_normal((n, 4, 512)),
            "b": rng.standard_normal((n, 7))}
    wg = {"w": rng.standard_normal((4, 512)), "b": np.zeros((7,))}
    return ({k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in pods.items()},
            {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in wg.items()})


def _wire_tree():
    """The toy's global model as ``meta`` tensors: what the specs read."""
    return {k: torch.empty(v.shape, device="meta")
            for k, v in _toy(torch.device("cpu"))[1].items()}


# ---------------------------------------------------------------------------
# The round targets: run on the spawned ranks, held to the rule here
# ---------------------------------------------------------------------------

def _round_inputs(cfg: HermesConfig, dev: torch.device, groups):
    """This rank's rows of the toy pods and of a gate state whose history
    the round's losses (2.0, 2.05) beat, so every gate opens."""
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync as hs
    pods, wg = _toy(dev)
    gup = hs.hermes_pod_state(cfg, N_PODS, dev)
    for level in (3.0, 3.2):
        _, gup = gup_gate(gup, torch.full((N_PODS,), level, device=dev), cfg)
    rows = groups.rows
    losses = 2.0 + 0.05 * torch.arange(N_PODS, device=dev,
                                       dtype=torch.float32)
    return ({k: v[rows] for k, v in pods.items()},
            {k: v[rows] for k, v in gup.items()}, losses[rows], wg,
            torch.tensor(1.0, device=dev))


def _round_targets(mode: Optional[str], dev: torch.device, groups,
                   log: List) -> Dict[str, Any]:
    """Every round target on this rank: ``{label: its records}``."""
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.dist.wire import GeneratorNoise
    out: Dict[str, Any] = {}

    def run(label, fn):
        start = len(log)
        result = fn()
        out[label] = C.records(log[start:], groups)
        return result

    cfg = _cfg(mode)
    m = cfg.compression
    kw = dict(round_step=1, noise=GeneratorNoise(0, dev), groups=groups)
    pods, gup, losses, wg, L = _round_inputs(cfg, dev, groups)
    opened = run(f"hermes_round[{m}]", lambda: hs.hermes_round(
        pods, gup, losses, wg, L, cfg, **kw))
    closed = run(f"hermes_round_closed[{m}]", lambda: hs.hermes_round(
        pods, gup, losses, wg, L, cfg,
        live=torch.zeros((N_PODS,), dtype=torch.bool, device=dev), **kw))
    if not opened["merged"] or closed["merged"]:
        raise AssertionError(f"the open round merged {opened['merged']}, "
                             f"the closed one {closed['merged']}")
    dp = run(f"hermes_dispatch[{m}]", lambda: hs.hermes_dispatch(
        pods, gup, losses, wg, L, cfg, **kw))
    # the commit as train_hermes runs it; it consumes its pods, and the
    # later targets read the originals
    _, commit = make_async_round_fns(cfg, groups)
    args = (tree_map(torch.clone, pods), dp["pending"], wg)
    label = f"hermes_commit[{m}]"
    _, aliasing = run(label, lambda: trace_aliasing(commit, *args,
                                                    device=dev))
    out.setdefault("donation", {})[label] = _donation(
        aliasing, {"pod_params": donated_leaf_ranges(args, (0,))[0]})
    for admission in ("topk", "prob"):
        acfg = _cfg(mode, participation_rate=0.5, admission=admission)
        tag = f"{m},prate=0.5,{admission}"
        # ``prob`` admits each open pod by a draw, so a round may admit
        # none and ship nothing: the first round step that admits one is
        # the target (every rank draws the same)
        for step in range(1, 33):
            akw = {**kw, "round_step": step}
            got = run(f"hermes_round[{tag}]", lambda: hs.hermes_round(
                pods, gup, losses, wg, L, acfg, **akw))
            if got["merged"]:
                break
        dp = run(f"hermes_dispatch[{tag}]", lambda: hs.hermes_dispatch(
            pods, gup, losses, wg, L, acfg, **akw))
        if not (got["merged"] and hs.pending_merges(dp["pending"])):
            raise AssertionError(f"{tag}: no round step in 1-32 admitted a "
                                 f"pod")
    return out


def _train_target(dev: torch.device, groups, log: List,
                  arch: str = "qwen3-8b") -> Dict[str, Any]:
    """The Level-B local train step of ``arch``'s smoke model on this
    rank, one step through ``launch/steps.py``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_setup
    cfg = get_smoke_config(arch)
    shape = ShapeConfig("analyze_smoke", 32, 8, "train")
    setup = make_train_setup(cfg, shape, ParallelConfig(),
                             OptimizerConfig(name="adamw", lr=1e-3),
                             device=dev)
    state = setup.init_state(0)
    gen = torch.Generator(device=dev).manual_seed(groups.rank)
    batch = {k: torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                              device=dev)
             for k, spec in setup.arg_specs[1].items()}
    start = len(log)
    (_, loss), aliasing = trace_aliasing(setup.step_fn, state, batch,
                                         device=dev)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"train_step[{arch}] loss {loss}")
    label = f"train_step[{arch}]"
    return {label: C.records(log[start:], groups),
            "donation": {label: _donation(aliasing, {
                "train_state": donated_leaf_ranges((state, batch),
                                                   (0,))[0]})}}


def _donation(aliasing: Aliasing, donated: Dict[str, Any]
              ) -> Dict[str, Any]:
    """A target's donation record as a rank reports it: the call's
    storages and each donated label's flat leaf range."""
    return {"aliasing": aliasing.to_json(),
            "donated": {k: list(v) for k, v in donated.items()}}


def _fp32_hoist_target(dev: torch.device, groups, log: List
                       ) -> Dict[str, Any]:
    """The reference's GSPMD regression, written out: a ship that gathers
    each pod's fp32 delta across the pod axis where the wire gathers its
    fp16 payload."""
    from repro_torch.dist.wire import all_gather_rows
    pods, _, _, wg, _ = _round_inputs(_cfg("fp16"), dev, groups)
    pod, size = groups.group("pod")
    start = len(log)
    for k in sorted(pods):
        all_gather_rows(pods[k] - wg[k][None], pod, size)  # BUG (deliberate)
    return {"selftest[fp32-hoist]": C.records(log[start:], groups)}


def _targets_main(rank: int, world: int, job: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """One rank of :func:`run_round_targets`."""
    from repro_torch.launch.mesh import make_pod_groups
    torch.set_num_threads(job["threads"])
    dev = torch.device(job["device"])
    groups = make_pod_groups(N_PODS)
    log: List = []
    C.count_collectives(log)
    report = _round_targets(job["mode"], dev, groups, log)
    train = _train_target(dev, groups, log)
    report["donation"].update(train.pop("donation"))
    report.update(train)
    report.update(_fp32_hoist_target(dev, groups, log))
    return report


def run_round_targets(mode: Optional[str] = None, device="cuda", *,
                      timeout: float = 300.0,
                      workdir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Spawn ``N_PODS`` gloo ranks once (``launch.spawn.spawn_ranks``)
    and run every round target, the train step and the fp32-hoist fixture
    on them; returns each rank's ``{label: records}``.  A failed rank
    fails the run with its traceback."""
    dev = resolve_device(device)
    job = {"mode": mode, "device": str(dev),
           "threads": max(1, torch.get_num_threads() // N_PODS)}
    return spawn_ranks(N_PODS, job, _targets_main, timeout=timeout,
                       workdir=workdir)


def _rule_for(label: str):
    """The rule a round target is held to, by its label."""
    mode = label[label.index("[") + 1:].split(",")[0].rstrip("]")
    if label.startswith(("hermes_round_closed",)):
        return C.closed_rule(N_PODS)
    if label.startswith(("hermes_commit", "train_step")):
        return C.pod_local_rule(N_PODS)
    return C.placement_rule(_wire_tree(), mode, N_PODS)


def _held(label: str, per_rank: List[Dict[str, Any]], rule_for=_rule_for,
          fail: bool = True) -> Report:
    """One target's records, rank by rank, held to its rule, and a target
    that donates to the donation rule too: one report over every rank's
    violations."""
    violations, rules = [], []
    for r, recs in enumerate(per_rank):
        rule_set, aliasing = [rule_for(label)], None
        donation = recs.get("donation", {}).get(label)
        if donation is not None:
            rule_set.append(DonationAliasing(
                {k: range(*v) for k, v in donation["donated"].items()}))
            aliasing = Aliasing.from_json(donation["aliasing"])
        rep = analyze(rule_set, collectives=recs[label], aliasing=aliasing,
                      label=f"{label}@rank{r}", fail=False)
        violations += rep.violations
        rules = rep.rules
    report = Report(label=label, violations=violations, rules=rules)
    return report.raise_if_failed() if fail else report


def _labels(per_rank, prefix) -> List[str]:
    return [k for k in per_rank[0] if k.startswith(prefix)]


def check_hermes_round(per_rank) -> List[Report]:
    """The open round ships exactly the billed wire; the closed round only
    the gate exchange."""
    return [_held(k, per_rank) for k in _labels(per_rank, "hermes_round")
            if "prate" not in k]


def check_async_halves(per_rank) -> List[Report]:
    """The dispatch carries the gather; the commit issues no collective
    and its donated pods alias its output's."""
    return [_held(k, per_rank) for k in _labels(per_rank, "hermes_dispatch")
            if "prate" not in k] + \
        [_held(k, per_rank) for k in _labels(per_rank, "hermes_commit")]


def check_admission(per_rank) -> List[Report]:
    """Admission at participation 0.5, ``topk`` and ``prob``, changes which
    gates ship, never the wire: the round and the dispatch hold to the
    unchanged specs."""
    return [_held(k, per_rank) for k in per_rank[0] if "prate=0.5" in k]


def check_train_step(per_rank) -> List[Report]:
    """The local train step crosses the pod axis with nothing and its
    donated state aliases in place."""
    return [_held(k, per_rank) for k in _labels(per_rank, "train_step")]


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


def selftest_fp32_hoist(per_rank) -> Dict[str, Any]:
    """The reference's GSPMD-hoist regression: a ship that gathers the fp32
    delta in place of the fp16 payload must raise ``fp32-model-crossing``
    (the fixture's records come from the spawned ranks)."""
    return _expect_violation(
        "fp32-hoist", "fp32-model-crossing",
        lambda: _held("selftest[fp32-hoist]", per_rank,
                      rule_for=lambda _: C.placement_rule(
                          _wire_tree(), "fp16", N_PODS)))


def selftest_dropped_donation(device: torch.device) -> Dict[str, Any]:
    """The bare functional commit (``hs.hermes_commit`` without
    ``in_place``): it rebuilds the pod tree with ``torch.where``, so the
    donated pods come back in no output's storage and the rule must name
    ``dropped-donation``.  Unplaced, every gate open."""
    from repro_torch.core.gup import gup_gate
    from repro_torch.dist import hermes_sync as hs
    from repro_torch.dist.wire import GeneratorNoise
    cfg = _cfg()
    pods, wg = _toy(device)
    gup = hs.hermes_pod_state(cfg, N_PODS, device)
    for level in (3.0, 3.2):
        _, gup = gup_gate(gup, torch.full((N_PODS,), level, device=device),
                          cfg)
    losses = 2.0 + 0.05 * torch.arange(N_PODS, device=device,
                                       dtype=torch.float32)
    dp = hs.hermes_dispatch(pods, gup, losses, wg,
                            torch.tensor(1.0, device=device), cfg,
                            round_step=1, noise=GeneratorNoise(0, device))
    args = (pods, dp["pending"], wg)
    _, aliasing = trace_aliasing(  # BUG (deliberate): nothing donated
        lambda p, pend, w: hs.hermes_commit(p, pend, w, cfg=cfg), *args,
        device=device)
    lo, hi = donated_leaf_ranges(args, (0,))[0]
    return _expect_violation(
        "dropped-donation", "dropped-donation",
        lambda: analyze([DonationAliasing({"pod_params": range(lo, hi)})],
                        aliasing=aliasing,
                        label="selftest[dropped-donation]"))


def run_selftests(device: torch.device, per_rank=None
                  ) -> List[Dict[str, Any]]:
    """Every fixture; the fp32 hoist's with the ranks' records (the round
    targets' run)."""
    return ([] if per_rank is None else [selftest_fp32_hoist(per_rank)]) + \
        [selftest_dropped_donation(device), selftest_host_sync_loop(),
         selftest_bad_tiles(device)]


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--self-test", action="store_true",
                    help="also run the violating fixtures (each must fail "
                         "with its named violation class)")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks' rounds and the fixture's copy run "
                         "(default: the card)")
    ap.add_argument("--mode", default=None,
                    help="wire format of the round targets (default: "
                         "HermesConfig's)")
    ap.add_argument("--out", default=None, help="write a JSON report")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    per_rank = run_round_targets(args.mode, device)
    reports = (check_hermes_round(per_rank) + check_async_halves(per_rank)
               + check_admission(per_rank) + check_train_step(per_rank)
               + check_round_loop_source() + check_kernels())
    for r in reports:
        print(f"  ok {r.label} ({', '.join(r.rules)})")
    record: Dict[str, Any] = {
        "device": str(device),
        "n_pods": N_PODS,
        "targets": [r.to_json() for r in reports],
        "ok": all(r.ok for r in reports),
    }
    if args.self_test:
        record["self_test"] = run_selftests(device, per_rank)
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
