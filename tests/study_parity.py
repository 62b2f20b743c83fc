"""Helpers of the study and example parity tests: a module of the JAX
package's scripts (``benchmarks/``, ``examples/``) and its port, both
with ``run_framework`` and ``make_paper_bundle`` replaced by the whole-run
settings of ``level_a_parity`` (n 600, 4 workers, one SGD step an
iteration, at most 32 iterations, no target, wall-clock or patience stop,
one set of initial parameters, the reference's int4 dither)."""
import importlib.util
from pathlib import Path

import torch

import level_a_parity as lap
from repro.core import simulator as jsim
from repro.core.allocator import Allocation as JAllocation
from repro_torch.core import simulator as tsim
from repro_torch.core.allocator import Allocation

from torch_parity import jax_noise

ROOT = Path(__file__).resolve().parents[1]
MAX_ITERATIONS = 32


def load_reference(relpath: str):
    """A script of the JAX package (``benchmarks/x.py``) as a module."""
    name = "reference_" + relpath.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _capped(run, allocation, record, max_iterations, num_workers):
    """``run_framework`` at the parity settings: the study's own
    framework, Hermes config, seed, eval and allocation cadence and
    iteration cap (at most ``max_iterations``), ``num_workers`` workers
    (``None``: the study's own count), the rest fixed."""
    def capped(framework, bundle, **kw):
        kw.update(num_workers=num_workers or kw["num_workers"],
                  init_alloc=allocation(lap.DSS, lap.MBS),
                  max_wall=lap.RUN["max_wall"],
                  patience=lap.RUN["patience"],
                  max_iterations=min(kw.get("max_iterations", 20000),
                                     max_iterations),
                  target_acc=max(kw.get("target_acc", 0.95),
                                 lap.RUN["target_acc"]))
        r = run(framework, bundle, **kw)
        record.append(r)
        return r
    return capped


def patch_pair(monkeypatch, jmod, tmod, max_iterations=MAX_ITERATIONS,
               num_workers=lap.RUN["num_workers"]):
    """Patch both modules; returns the two lists of ``RunResult``s their
    runs produce.  Bundles are built once per dataset and shared, so both
    packages start from the reference's initial parameters."""
    monkeypatch.setattr(tsim, "comp_noise",
                        lambda seed, device: jax_noise(seed))
    cache = {}

    def pair(dataset):
        if dataset not in cache:
            cache[dataset] = lap.bundles(dataset)
        return cache[dataset]

    runs = ([], [])
    monkeypatch.setattr(jmod, "make_paper_bundle",
                        lambda dataset, **kw: (pair(dataset)[0],
                                               pair(dataset)[2]))
    monkeypatch.setattr(tmod, "make_paper_bundle",
                        lambda dataset, **kw: (pair(dataset)[1],
                                               pair(dataset)[2]))
    monkeypatch.setattr(jmod, "run_framework",
                        _capped(jsim.run_framework, JAllocation, runs[0],
                                max_iterations, num_workers))
    monkeypatch.setattr(tmod, "run_framework",
                        _capped(tsim.run_framework, Allocation, runs[1],
                                max_iterations, num_workers))
    return runs


def one_thread(fn, *args, **kw):
    """The port's side on one thread: the batches are tiny, and test
    processes run side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(threads)


def pushes(runs) -> int:
    return sum(p for r in runs for *_, p in r.gup_trace)


def assert_same_runs(want_runs, got_runs):
    """The runs behind a study's output, pairwise (``assert_same_run``)."""
    n_test = lap.N - int(lap.N * 0.85)  # the 85/15 split's test set
    assert len(got_runs) == len(want_runs) > 0
    for want, got in zip(want_runs, got_runs):
        lap.assert_same_run(want, got, n_test)


def study_both(monkeypatch, tmod, call, **kw):
    """``call(module, kwargs)`` on the study ``tmod`` of
    ``repro_torch.studies`` (with ``device="cpu"``) and on the reference's
    script of the same name under ``benchmarks/``, both patched: the runs
    are held pairwise and the outputs must be equal.  Returns the output
    and the reference's runs."""
    jmod = load_reference(f"benchmarks/{tmod.__name__.rsplit('.', 1)[1]}.py")
    jruns, truns = patch_pair(monkeypatch, jmod, tmod, **kw)
    want = call(jmod, {})
    got = one_thread(call, tmod, {"device": "cpu"})
    assert_same_runs(jruns, truns)
    assert got == want
    return want, jruns
