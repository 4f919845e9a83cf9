"""FL fine-tuning of the registry's LMs (reduced configs) — the port of
``repro.fl.lm_trainer`` (``LmFlTrainer``).

Ties the paper's technique to the model zoo: each client holds a contiguous
shard of a synthetic token stream (``data/synthetic.make_token_stream``);
a local update is ``steps_per_round`` plain SGD steps of the causal-LM loss
(the gradient through the attention and scan kernels' autograd Functions
on the card, kernels/ops.py); aggregation is FedAvg (``fl/aggregation``,
the CUDA ``fedavg_combine`` kernel on the card).  Batch starts come from
``numpy.random.default_rng(seed)`` in the JAX package's order, so both
packages train on the same batches.  ``params`` replaces the port's own
init (e.g. ``convert.lm_params_from_tree`` of the JAX package's);
``device`` None means the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.synthetic import make_token_stream
from repro_torch.fl.aggregation import fedavg
from repro_torch.fl.server import LocalTrainer
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.registry import build
from repro_torch.sim.engine import resolve_device
from repro_torch.utils.trees import tree_map


class LmFlTrainer(LocalTrainer):
    def __init__(self, arch: str, n_clients: int, n_samples: np.ndarray,
                 seed: int = 0, seq_len: int = 64, batch_size: int = 4,
                 steps_per_round: int = 4, lr: float = 0.5,
                 params: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.api = build(arch, reduced=True)
        cfg = self.api.cfg
        stream = make_token_stream(200_000, cfg.vocab, seed=seed)
        # each client owns a contiguous shard
        bounds = np.linspace(0, len(stream) - seq_len - 1, n_clients + 1,
                             dtype=int)
        self.shards = [(bounds[i], bounds[i + 1]) for i in range(n_clients)]
        self.stream = stream
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.steps = steps_per_round
        self.lr = lr
        self.rng = np.random.default_rng(seed)
        if params is None:
            params = self.api.init(torch.Generator().manual_seed(seed))
        params = tree_map(lambda x: x.to(self.device), params)
        super().__init__(params, self._client_update_impl,
                         self._aggregate_impl)
        self.last_losses: list[float] = []
        self.loss_log: list[float] = []     # every step's loss, in order

    def _sgd_step(self, p, batch):
        loss, grads = value_and_grad(self.api.loss_fn, p, batch)
        with torch.no_grad():
            p = tree_map(lambda w, g: w - self.lr * g, p, grads)
        return p, loss

    def _batch(self, lo: int, hi: int) -> dict:
        starts = self.rng.integers(lo, max(hi - self.seq_len - 1, lo + 1),
                                   size=self.batch_size)
        toks = np.stack([self.stream[s:s + self.seq_len] for s in starts])
        return {"tokens": torch.as_tensor(toks, dtype=torch.int32,
                                          device=self.device)}

    def _client_update_impl(self, params, k: int, rnd: int):
        lo, hi = self.shards[k]
        p = params
        losses = []
        for _ in range(self.steps):
            p, loss = self._sgd_step(p, self._batch(lo, hi))
            losses.append(float(loss))
        self.last_losses = losses
        self.loss_log += losses
        return p, float(hi - lo)

    def _aggregate_impl(self, global_params, results):
        return fedavg([p for p, _ in results], [w for _, w in results])

    @torch.no_grad()
    def accuracy(self) -> float:
        """Proxy metric: exp(-loss) on a held-out batch."""
        batch = self._batch(0, len(self.stream) - self.seq_len - 1)
        loss = float(self.api.loss_fn(self.params, batch))
        return float(np.exp(-loss))
