"""Federated dataset partitioning — the port's numpy copy of
``repro.data.partition`` (``iid_partition``, ``dirichlet_partition``,
``pad_partitions``).

IID split: each client samples its D_k images from the global training set
(paper Sect. IV-B).  Dirichlet non-IID split: client k's label distribution
is drawn from Dirichlet(alpha).  Byte-identical to the JAX package's for the
same generator state (tests/test_torch_fl_data.py).
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import ImageDataset


def iid_partition(dataset: ImageDataset, n_samples_per_client: np.ndarray,
                  rng: np.random.Generator) -> list[np.ndarray]:
    """Per-client index arrays into ``dataset``: each client draws its D_k
    images without replacement; clients may share images."""
    n = dataset.x.shape[0]
    return [rng.choice(n, size=int(d), replace=False)
            for d in n_samples_per_client]


def dirichlet_partition(dataset: ImageDataset,
                        n_samples_per_client: np.ndarray, alpha: float,
                        rng: np.random.Generator,
                        n_classes: int = 10) -> list[np.ndarray]:
    """Non-IID split: client k's label distribution ~ Dirichlet(alpha).

    Every client gets exactly its requested D_k samples: per-class draws are
    capped at the class size and the shortfall is redistributed over the
    classes with room, in proportion to the client's Dirichlet weights.
    """
    by_class = [np.flatnonzero(dataset.y == c) for c in range(n_classes)]
    sizes = np.array([len(b) for b in by_class])
    if int(np.max(n_samples_per_client, initial=0)) > int(sizes.sum()):
        raise ValueError("a client requests more samples than the dataset has")
    parts = []
    for d in n_samples_per_client:
        d = int(d)
        p = rng.dirichlet(alpha * np.ones(n_classes))
        counts = np.minimum(rng.multinomial(d, p), sizes)
        while counts.sum() < d:
            room = sizes - counts
            q = np.where(room > 0, p, 0.0)
            q = q / q.sum() if q.sum() > 0 else (room > 0) / (room > 0).sum()
            counts += np.minimum(rng.multinomial(d - counts.sum(), q), room)
        idx = np.concatenate([
            rng.choice(by_class[c], size=counts[c], replace=False)
            for c in range(n_classes) if counts[c] > 0
        ]) if d > 0 else np.empty(0, np.int64)
        rng.shuffle(idx)
        parts.append(idx)
    return parts


def pad_partitions(parts: list[np.ndarray], cap: int | None = None,
                   round_to: int | None = None) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Pack per-client index lists into ``(idx [K, cap] int32, count [K]
    int32)``.  Padding repeats the client's first index, so gathers stay in
    bounds; consumers mask by ``count``.  ``cap`` defaults to the largest
    shard (longer shards are truncated); ``round_to`` floors the cap at that
    value and rounds it up to a multiple of it (the batch size, for the
    client update's valid-batch mask).
    """
    counts = np.array([len(p) for p in parts], np.int64)
    cap = int(counts.max(initial=1)) if cap is None else int(cap)
    if round_to is not None:
        cap = -(-max(cap, round_to) // round_to) * round_to
    counts = np.minimum(counts, cap)
    idx = np.zeros((len(parts), cap), np.int64)
    for i, p in enumerate(parts):
        n = int(counts[i])
        if n:
            idx[i, :n] = p[:n]
            idx[i, n:] = p[0]
    return idx.astype(np.int32), counts.astype(np.int32)
