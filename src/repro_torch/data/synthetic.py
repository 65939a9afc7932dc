"""Synthetic data (counterpart of ``repro/data/synthetic.py``): a
Zipf-distributed Markov token source for LMs and a separable Gaussian-mixture
image source for the conv path, drawn with the same numpy RNG streams as the
JAX package, so both packages see identical batches from one seed."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def _markov_table(vocab: int, seed: int, branch: int = 8):
    """Sparse row-stochastic transition table with Zipf marginals."""
    rng = np.random.RandomState(seed)
    nexts = rng.randint(0, vocab, size=(vocab, branch))
    probs = rng.dirichlet(np.ones(branch) * 0.5, size=vocab)
    return nexts, probs


def lm_batch(rng: np.random.RandomState, nexts, probs, batch: int,
             seq_len: int) -> dict:
    """One next-token-prediction batch from the Markov source: int32
    ``tokens`` and ``labels`` (B, S) on the CPU."""
    vocab, branch = nexts.shape
    toks = np.empty((batch, seq_len + 1), np.int32)
    toks[:, 0] = rng.randint(0, vocab, size=batch)
    for t in range(seq_len):
        choice = np.array([rng.choice(branch, p=probs[tok])
                           for tok in toks[:, t]])
        toks[:, t + 1] = nexts[toks[:, t], choice]
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def token_batches(vocab: int, batch: int, seq_len: int, *,
                  seed: int = 0) -> Iterator[dict]:
    """Infinite LM batch iterator."""
    nexts, probs = _markov_table(vocab, seed)
    rng = np.random.RandomState(seed + 1)
    while True:
        yield lm_batch(rng, nexts, probs, batch, seq_len)


def image_batches(n_classes: int, batch: int, size: int = 32,
                  channels: int = 3, *, seed: int = 0,
                  device=None) -> Iterator[dict]:
    """Gaussian-mixture images: a class-dependent low-frequency pattern
    plus noise, learnable by a small ConvNet within a few hundred steps.
    Yields f32 ``images`` (B, size, size, channels) channels-last and int64
    ``labels`` (B,), on ``device`` (the CPU by default)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_classes, size, size, channels).astype(np.float32)
    # low-pass the prototypes so convs with small kernels can pick them up
    for _ in range(3):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, 1, 2)) / 3
    while True:
        labels = rng.randint(0, n_classes, size=batch)
        imgs = protos[labels] + 0.5 * rng.randn(batch, size, size,
                                                channels).astype(np.float32)
        yield {"images": torch.from_numpy(imgs).to(device),
               "labels": torch.from_numpy(labels).to(device)}
