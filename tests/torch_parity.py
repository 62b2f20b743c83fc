"""Helpers shared by the port's parity tests: numpy <-> torch, and the
reference's int4 rounding noise for injection into the port."""
import numpy as np
import torch
import jax


def to_torch(a) -> torch.Tensor:
    """A writable CPU tensor copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def jax_noise(seed: int):
    """The reference's int4 noise as a port ``NoiseFn``: the uniform draw
    of ``fold_in(fold_in(PRNGKey(seed), round_step), leaf)``, which is what
    ``train_hermes`` and ``encode_tree`` hand ``Int4Format._round``."""
    def draw(round_step, leaf, shape):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), round_step), leaf)
        return np.array(jax.random.uniform(key, shape))
    return draw
