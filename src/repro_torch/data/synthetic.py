"""Deterministic synthetic LM data (numpy; a copy of the reference's
``data/synthetic.make_lm_dataset`` and ``launch/train.make_batches``, so
one seed gives both sides the same token stream)."""
from __future__ import annotations

from typing import Dict, Iterator

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
                 rng: np.random.Generator
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless random windows of ``seq`` tokens; int64 CPU tensors."""
    n = (len(tokens) - 1) // seq
    while True:
        idx = rng.integers(0, n, batch)
        x = np.stack([tokens[i * seq:(i + 1) * seq] for i in idx])
        y = np.stack([tokens[i * seq + 1:(i + 1) * seq + 1] for i in idx])
        yield {"tokens": torch.from_numpy(x.astype(np.int64)),
               "targets": torch.from_numpy(y.astype(np.int64))}
