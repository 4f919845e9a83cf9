"""The paper's CNN + synthetic CIFAR + local SGD as a ``LocalTrainer`` — the
port of ``repro.fl.cnn_trainer`` (``CnnFlTrainer``, ``evaluate``).

The paper's per-round client recipe — 5 epochs of minibatch-50 SGD at lr
0.25 * 0.99^round (optim/sgd.py), FedAvg weighted by D_k — one client at a
time, through the same client update the learning-coupled engine runs for
many clients at once (``fl/engine.make_client_update``, here on one
[1, N] row).  The aggregation is ``fl/aggregation.fedavg``: on the card the
CUDA ``fedavg_combine`` kernel (#5), one launch a round.

Each client's epoch orders come from a CPU ``torch.Generator`` seeded from
(seed, round, client), so the card and the CPU train on the same orders;
the JAX package derives them from ``fold_in(fold_in(key, round), client)``
instead, and ``orders`` lets a caller feed those (or any) orders in.
Images live on the trainer's device in NCHW.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.data.partition import iid_partition, pad_partitions
from repro_torch.data.synthetic import make_synthetic_cifar
from repro_torch.fl.aggregation import fedavg
from repro_torch.fl.engine import draw_orders, make_client_update
from repro_torch.fl.server import LocalTrainer
from repro_torch.models import cnn
from repro_torch.optim.sgd import PAPER_LR0, PAPER_LR_DECAY
from repro_torch.sim.engine import resolve_device
from repro_torch.utils.trees import FlatSpec, flatten, unflatten


@torch.no_grad()
def evaluate(params: dict, x: torch.Tensor, y: torch.Tensor,
             cfg: cnn.CnnConfig = cnn.CnnConfig(), batch: int = 500) -> float:
    """Test accuracy over NCHW images ``x`` and labels ``y`` in chunks of
    ``batch`` (BatchNorm on each chunk's own statistics, as the JAX
    package's evaluator)."""
    correct = 0
    for s in range(0, len(y), batch):
        pred = cnn.forward(params, x[s:s + batch], cfg).argmax(-1)
        correct += int((pred == y[s:s + batch]).sum())
    return correct / len(y)


class CnnFlTrainer(LocalTrainer):
    """Paper Sect. IV-B training setup against the synthetic CIFAR task.

    ``cfg`` sets the CNN (and the images' size); ``params`` replaces the
    port's own init (e.g. ``convert.cnn_params_from_jax`` of the JAX
    package's); ``orders(rnd, k)`` returns client k's [E, cap] epoch orders
    of round ``rnd`` (positions into its padded shard) in place of the
    trainer's own draw; ``device`` None means the card.
    """

    def __init__(self, n_clients: int, n_samples_per_client: np.ndarray,
                 seed: int = 0, n_train: int = 50_000, n_test: int = 10_000,
                 batch_size: int = 50, epochs: int = 5,
                 lr0: float = PAPER_LR0, lr_decay: float = PAPER_LR_DECAY,
                 cfg: cnn.CnnConfig = cnn.CnnConfig(),
                 params: dict | None = None,
                 orders: Callable[[int, int], np.ndarray] | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.seed = seed
        self.train_set, self.test_set = make_synthetic_cifar(
            n_train=n_train, n_test=n_test, size=cfg.image_size, seed=seed)
        rng = np.random.default_rng(seed + 1)
        self.parts = iid_partition(self.train_set, n_samples_per_client, rng)
        idx, count = pad_partitions(self.parts, round_to=batch_size)
        self.part_idx = torch.as_tensor(idx, dtype=torch.int64,
                                        device=self.device)
        self.part_count = torch.as_tensor(count, dtype=torch.int64)
        self.batch_size = batch_size
        self.epochs = epochs
        self.lr0, self.lr_decay = lr0, lr_decay
        self.orders = orders
        self._update = make_client_update(cfg, epochs=epochs,
                                          batch_size=batch_size)
        self._train_x = self._nchw(self.train_set.x)
        self._train_y = torch.as_tensor(self.train_set.y, dtype=torch.int64,
                                        device=self.device)
        self._test_x = self._nchw(self.test_set.x)
        self._test_y = torch.as_tensor(self.test_set.y, dtype=torch.int64,
                                       device=self.device)
        if params is None:
            params = cnn.init(torch.Generator().manual_seed(seed), cfg)
        params = {n: p.to(self.device, torch.float32)
                  for n, p in params.items()}
        self.spec = FlatSpec.of_tree(params)
        super().__init__(params, self._client_update_impl,
                         self._aggregate_impl)

    def _nchw(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(
            self.device)

    def client_orders(self, rnd: int, k: int) -> torch.Tensor:
        """Client k's [E, cap] epoch orders of round ``rnd``."""
        if self.orders is not None:
            order = torch.as_tensor(np.asarray(self.orders(rnd, k)),
                                    dtype=torch.int64)
        else:
            seed = np.random.SeedSequence(
                [self.seed + 2, rnd, k]).generate_state(1)[0]
            gen = torch.Generator().manual_seed(int(seed))
            order = draw_orders(gen, 1, self.part_count[k:k + 1],
                                self.epochs, self.part_idx.shape[1])[0, 0]
        return order.to(self.device)

    # ------------------------------------------------------------------
    def _client_update_impl(self, params, k: int, rnd: int):
        rows = flatten(params, self.spec)[None]
        lr = self.lr0 * self.lr_decay ** rnd
        self._update(rows, self.spec, self._train_x, self._train_y,
                     self.part_idx[k:k + 1],
                     self.part_count[k:k + 1].to(self.device), lr,
                     self.client_orders(rnd, k)[None])
        return unflatten(rows[0], self.spec), float(self.part_count[k])

    def _aggregate_impl(self, global_params, results):
        return fedavg([p for p, _ in results], [w for _, w in results])

    def accuracy(self) -> float:
        return evaluate(self.params, self._test_x, self._test_y, self.cfg)
