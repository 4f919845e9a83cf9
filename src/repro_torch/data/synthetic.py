"""Synthetic CIFAR-shaped images — the port's numpy copy of
``repro.data.synthetic`` (``ImageDataset``, ``make_synthetic_cifar``).

A class-conditional synthetic distribution with CIFAR's tensor shapes
(32x32x3 float32 in [0, 1], 10 classes, 50k train / 10k test): each class
has a smooth random prototype (a few low-frequency Fourier modes) and a
sample is the prototype plus per-sample noise and a brightness/contrast
jitter.  The same seed gives byte-identical arrays in both packages
(tests/test_torch_fl_data.py), so the two train on the same images.

``make_token_stream`` is the LM trainers' synthetic token stream (a sparse
bigram chain), bitwise the JAX package's on the same seed
(tests/test_torch_host_fl.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x: np.ndarray    # [N, H, W, 3] float32
    y: np.ndarray    # [N] int32


def _lowfreq_pattern(rng: np.random.Generator, size: int,
                     n_modes: int = 4) -> np.ndarray:
    """Smooth random pattern via a few random 2-D Fourier modes."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    img = np.zeros((size, size, 3), np.float64)
    for _ in range(n_modes):
        fx, fy = rng.uniform(0.5, 3.0, size=2)
        ph = rng.uniform(0, 2 * np.pi, size=3)
        amp = rng.uniform(0.3, 1.0, size=3)
        for c in range(3):
            img[:, :, c] += amp[c] * np.sin(
                2 * np.pi * (fx * xx + fy * yy) + ph[c])
    img -= img.min()
    img /= max(img.max(), 1e-9)
    return img


def make_synthetic_cifar(n_train: int = 50_000, n_test: int = 10_000,
                         n_classes: int = 10, size: int = 32,
                         noise: float = 0.35, seed: int = 0
                         ) -> tuple[ImageDataset, ImageDataset]:
    """(train, test) datasets drawn from one ``numpy`` generator."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_lowfreq_pattern(rng, size) for _ in range(n_classes)])

    def sample(n):
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = protos[y]
        x = x + noise * rng.standard_normal(x.shape)
        # per-sample random brightness/contrast jitter
        gain = rng.uniform(0.8, 1.2, size=(n, 1, 1, 1))
        bias = rng.uniform(-0.1, 0.1, size=(n, 1, 1, 1))
        x = np.clip(x * gain + bias, 0.0, 1.0).astype(np.float32)
        return ImageDataset(x=x, y=y)

    return sample(n_train), sample(n_test)


def make_token_stream(n_tokens: int, vocab: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Markov-ish synthetic token stream (learnable bigram structure)."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition: each token prefers a few successors
    n_succ = 8
    succ = rng.integers(0, vocab, size=(min(vocab, 4096), n_succ))
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.integers(0, vocab)
    for i in range(1, n_tokens):
        prev = toks[i - 1] % succ.shape[0]
        if rng.uniform() < 0.8:
            toks[i] = succ[prev, rng.integers(0, n_succ)]
        else:
            toks[i] = rng.integers(0, vocab)
    return toks
