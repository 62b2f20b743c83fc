"""Deterministic synthetic data (numpy; a copy of the reference's
``data/synthetic.py`` and ``launch/train.make_batches``, so one seed gives
both sides the same arrays).

* ``make_lm_dataset`` / ``make_batches``: a Zipf Markov token stream and
  random windows of it, for the LM trainer.
* ``make_image_dataset``: the paper's MNIST / CIFAR stand-ins, class
  templates plus per-sample noise and a spatial jitter (no dataset files
  are needed); ``train_test_split`` the paper's 85/15 split.
* ``iid_partition`` / ``dirichlet_partition``: the paper's IID (MNIST)
  and Dirichlet class-skew (non-IID, CIFAR) worker shards.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def make_lm_dataset(n_tokens: int, vocab: int, *, seed: int = 0) -> np.ndarray:
    """Markov token stream with Zipf unigram marginals; (n_tokens,) int32."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, vocab + 1) ** 1.1
    base /= base.sum()
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.choice(vocab, p=base)
    boost = rng.integers(0, vocab, size=vocab)  # deterministic successor bias
    for i in range(1, n_tokens):
        if rng.random() < 0.6:
            toks[i] = boost[toks[i - 1]]
        else:
            toks[i] = rng.choice(vocab, p=base)
    return toks


def make_batches(tokens: np.ndarray, batch: int, seq: int,
                 rng: np.random.Generator, skip: int = 0
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless random windows of ``seq`` tokens; int64 CPU tensors.
    ``skip`` fast-forwards the index stream past that many batches without
    building them (a resumed run does not replay consumed batches)."""
    n = (len(tokens) - 1) // seq
    for _ in range(skip):
        rng.integers(0, n, batch)
    while True:
        idx = rng.integers(0, n, batch)
        x = np.stack([tokens[i * seq:(i + 1) * seq] for i in idx])
        y = np.stack([tokens[i * seq + 1:(i + 1) * seq + 1] for i in idx])
        yield {"tokens": torch.from_numpy(x.astype(np.int64)),
               "targets": torch.from_numpy(y.astype(np.int64))}


def make_image_dataset(n: int, image_shape: Tuple[int, int, int],
                       num_classes: int, *, seed: int = 0,
                       difficulty: float = 0.35,
                       label_noise: float = 0.0) -> Dict[str, np.ndarray]:
    """Returns {"images": (n,H,W,C) float32, "labels": (n,) int32}."""
    rng = np.random.default_rng(seed)
    H, W, C = image_shape
    # smooth class templates: superpose a few random low-frequency bumps
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    templates = np.zeros((num_classes, H, W, C), np.float32)
    for c in range(num_classes):
        for _ in range(4):
            cy, cx = rng.uniform(0.15, 0.85, 2) * (H, W)
            s = rng.uniform(0.08, 0.25) * H
            amp = rng.uniform(0.6, 1.4)
            bump = amp * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                                  / (2 * s * s)))
            ch = rng.integers(0, C)
            templates[c, :, :, ch] += bump
    templates /= np.maximum(templates.max(axis=(1, 2, 3), keepdims=True),
                            1e-6)

    labels = rng.integers(0, num_classes, n).astype(np.int32)
    shifts_y = rng.integers(-2, 3, n)
    shifts_x = rng.integers(-2, 3, n)
    images = templates[labels].copy()
    for i in range(n):  # cheap spatial jitter
        images[i] = np.roll(images[i], (shifts_y[i], shifts_x[i]),
                            axis=(0, 1))
    images += rng.normal(0, difficulty, images.shape).astype(np.float32)
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        labels[flip] = rng.integers(0, num_classes, int(flip.sum()))
    return {"images": images.astype(np.float32), "labels": labels}


def train_test_split(data: Dict[str, np.ndarray], test_frac: float = 0.15,
                     seed: int = 0):
    """The paper's fixed 85/15 split: ``(train, test)`` dicts."""
    n = len(data["labels"])
    perm = np.random.default_rng(seed).permutation(n)
    k = int(n * (1 - test_frac))
    return ({key: v[perm[:k]] for key, v in data.items()},
            {key: v[perm[k:]] for key, v in data.items()})


def iid_partition(n: int, num_workers: int, *, seed: int = 0
                  ) -> List[np.ndarray]:
    perm = np.random.default_rng(seed).permutation(n)
    return [np.sort(p) for p in np.array_split(perm, num_workers)]


def dirichlet_partition(labels: np.ndarray, num_workers: int, *,
                        alpha: float = 0.5, seed: int = 0
                        ) -> List[np.ndarray]:
    """Non-IID class-skew partition (standard federated benchmark recipe)."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    out: List[List[int]] = [[] for _ in range(num_workers)]
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_workers)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for w, part in enumerate(np.split(idx, cuts)):
            out[w].extend(part.tolist())
    return [np.sort(np.array(o, dtype=np.int64)) for o in out]
