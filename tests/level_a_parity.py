"""Helpers of the Level-A parity tests: one study run through the JAX
package's simulator and through the port's, from the same initial
parameters, and the comparison of the two ``RunResult``s."""
from collections import deque

import numpy as np
import torch
import jax

from repro.config import HermesConfig as JHermesConfig
from repro.core import bundles as jbundles
from repro.core import simulator as jsim
from repro.core.allocator import Allocation as JAllocation
from repro.core.gup import zscore

from repro_torch import bridge
from repro_torch.config import HermesConfig
from repro_torch.core import bundles as tbundles
from repro_torch.core import simulator as tsim
from repro_torch.core.allocator import Allocation

from torch_parity import jax_noise

#: the whole-run settings: a small mnist study on 4 workers, one SGD step
#: an iteration until the allocator resizes a shard, stopped by the
#: iteration cap alone (no target, no wall-clock or patience stop)
N = 600
RUN = dict(num_workers=4, target_acc=1.01, max_wall=1e9, patience=10 ** 6,
           eval_every=2)
DSS, MBS = 16, 16


def bundles(dataset="mnist", n=N, eval_batch=64):
    """The reference's bundle and the port's, the port's ``init``
    returning the reference's initial parameters."""
    jb, noniid = jbundles.make_paper_bundle(dataset, n=n,
                                            eval_batch=eval_batch)
    tb, _ = tbundles.make_paper_bundle(dataset, n=n, eval_batch=eval_batch)
    params0 = jax.device_get(jb.init(jax.random.PRNGKey(0)))
    tb.init = lambda gen, device: bridge.from_numpy(params0, device)
    return jb, tb, noniid


def run_both(monkeypatch, framework, *, hermes=None, dataset="mnist",
             engine="auto", **kw):
    """``run_framework`` in both packages on the CPU, both on ``engine``
    (``"auto"``: the legacy loops; ``"vector"``: the exact slot
    scheduler); the port's int4 dither is the reference's
    (``jax_noise``), injected through ``simulator.comp_noise``."""
    monkeypatch.setattr(tsim, "comp_noise",
                        lambda seed, device: jax_noise(seed))
    jb, tb, _ = bundles(dataset)
    hermes = hermes or {}
    kw = dict(RUN, engine=engine, **kw)
    want = jsim.run_framework(framework, jb,
                              hermes_cfg=JHermesConfig(**hermes),
                              init_alloc=JAllocation(DSS, MBS), **kw)
    # the batches are tiny: one thread, so that test processes running
    # side by side do not oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = tsim.run_framework(framework, tb,
                                 hermes_cfg=HermesConfig(**hermes),
                                 init_alloc=Allocation(DSS, MBS),
                                 device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    return want, got, len(jb.test_data["labels"])


def _gate_margins(trace, worker, upto, cfg):
    """z - alpha of ``worker``'s gate decisions in ``trace`` up to entry
    ``upto``, replayed from its losses (a rejoin's reset not modelled)."""
    q, alpha, n_iter, out = deque(maxlen=cfg.window), cfg.alpha, 0, []
    for t, w, loss, _ in trace[:upto + 1]:
        if w != worker:
            continue
        z = zscore(q, loss)
        out.append((t, z - alpha))
        q.append(loss)
        if z <= alpha:
            n_iter = 0
        else:
            n_iter += 1
            if n_iter >= cfg.lam:
                alpha, n_iter = min(alpha + cfg.beta, cfg.alpha_max), 0
        alpha = max(alpha, cfg.alpha_min)
    return out


def assert_same_run(want, got, n_test, hermes=None):
    """Counters, traces and events exactly; gate losses at rtol 1e-4;
    accuracies within 2 test samples."""
    for f in ("framework", "iterations", "ps_updates", "sim_time",
              "api_calls", "bytes_transferred", "calls_by_kind",
              "bytes_by_kind", "alloc_trace", "worker_iter_times",
              "comm_stall", "wi_avg"):
        assert getattr(got, f) == getattr(want, f), f
    assert list(got.meter_events) == list(want.meter_events)
    assert got.device == "cpu"
    gates_w = [(t, w, p) for t, w, _, p in want.gup_trace]
    gates_g = [(t, w, p) for t, w, _, p in got.gup_trace]
    if gates_g != gates_w:
        i = next((k for k, (a, b) in enumerate(zip(gates_w, gates_g))
                  if a != b), min(len(gates_w), len(gates_g)))
        msg = f"gate sequences differ at entry {i} of {len(gates_w)}"
        if i < min(len(gates_w), len(gates_g)):
            cfg = JHermesConfig(**(hermes or {}))
            worker = gates_w[i][1]
            msg += (f" ({worker}); z - alpha, reference "
                    f"{_gate_margins(want.gup_trace, worker, i, cfg)[-3:]}, "
                    f"port {_gate_margins(got.gup_trace, worker, i, cfg)[-3:]}")
        raise AssertionError(msg)
    np.testing.assert_allclose([l for _, _, l, _ in got.gup_trace],
                               [l for _, _, l, _ in want.gup_trace],
                               rtol=1e-4)
    assert [t for t, _ in got.history] == [t for t, _ in want.history]
    np.testing.assert_allclose([a for _, a in got.history],
                               [a for _, a in want.history],
                               atol=2 / n_test + 1e-7, rtol=0)
    assert abs(got.conv_acc - want.conv_acc) <= 2 / n_test + 1e-7
    assert got.reached_target == want.reached_target


#: the gate opens often (alpha -0.5, decays after 2 closed iterations)
HERMES = dict(alpha=-0.5, lam=2, eta=0.1, iqr_k=0.0)
STUDY = dict(max_iterations=32, alloc_every=0.3)


def check(monkeypatch, hermes, engine="auto", **kw):
    """One Hermes study in both packages on ``engine``, held by
    :func:`assert_same_run`; the gate both opens and closes, and the
    allocator resizes shards."""
    want, got, n_test = run_both(monkeypatch, "hermes", hermes=hermes,
                                 engine=engine, **dict(STUDY, **kw))
    assert_same_run(want, got, n_test, hermes)
    pushes = sum(p for *_, p in want.gup_trace)
    assert 0 < pushes < want.iterations == len(want.gup_trace)
    assert want.alloc_trace  # the allocator resized shards
    return want
