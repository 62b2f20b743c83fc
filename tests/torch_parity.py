"""Helpers shared by the port's parity tests: numpy <-> torch, and the
reference's int4 rounding noise for injection into the port.

Importing this module caps torch's CPU threads at one (intra-op, and
inter-op where no parallel work has started yet).  Under ``pytest -p
xdist -n N`` every worker collects every test module, and most of the
port's test modules import this one, so the cap holds in every worker.
Without it each worker's torch pool competes with the others and with
XLA's for the same cores: an lmtiny trainer parity case ran 2.6x slower
at the default thread counts on an 8-core host with nothing else
running, and the slowest cases of a 6-worker run took 2-4x their
single-worker times.  Helpers that set one thread around a run and
restore the count afterwards therefore restore one.  A test that starts
one of the port's entry points as a child process passes
:data:`CHILD_ENV` in its environment."""
import numpy as np
import torch
import jax

TORCH_THREADS = 1
# for the port's command-line entry points that a test runs as a child
# process: the same cap, read by torch there at start
CHILD_ENV = {"OMP_NUM_THREADS": str(TORCH_THREADS)}
torch.set_num_threads(TORCH_THREADS)
try:
    torch.set_num_interop_threads(TORCH_THREADS)
except RuntimeError:    # set already, or inter-op work has started
    pass


def to_torch(a) -> torch.Tensor:
    """A writable CPU tensor copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def leaf_shapes(preset: str, n_pods: int = 4):
    """Every parameter leaf shape of a reference preset, stacked
    ``n_pods`` deep, in the reference's leaf order (shapes only: nothing
    is allocated)."""
    from repro.launch.train import _preset
    from repro.models import init_lm
    shapes = jax.eval_shape(
        lambda: init_lm(_preset(preset), jax.random.PRNGKey(0))[0])
    return [(n_pods,) + tuple(s.shape) for s in jax.tree.leaves(shapes)]


class jax_noise:
    """The reference's int4 noise as a port ``NoiseFn``: the uniform draw
    of ``fold_in(fold_in(PRNGKey(seed), round_step), leaf)``, which is what
    ``train_hermes`` and ``encode_tree`` hand ``Int4Format._round``.
    ``fold(tag)`` is the stream of ``fold_in(round_key, tag)``: the
    two-tier round's slow tier draws from ``fold(0x5C1)``, as the
    reference's ``fold_in(rng, 0x5C1)``."""

    def __init__(self, seed: int, tags=()):
        self.seed, self.tags = seed, tuple(tags)

    def fold(self, tag: int) -> "jax_noise":
        return jax_noise(self.seed, self.tags + (int(tag),))

    def __call__(self, round_step, leaf, shape):
        key = jax.random.fold_in(jax.random.PRNGKey(self.seed), round_step)
        for tag in self.tags:
            key = jax.random.fold_in(key, tag)
        key = jax.random.fold_in(key, leaf)
        return np.array(jax.random.uniform(key, shape))
