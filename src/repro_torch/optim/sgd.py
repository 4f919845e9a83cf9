"""The paper's SGD schedule — the port of ``repro.optim.sgd``
(``PAPER_LR0``, ``PAPER_LR_DECAY``, ``paper_lr``) and of the engine's
``_round_lrs``.

Sect. IV-B: SGD, initial lr 0.25, multiplicative decay 0.99 per round,
minibatch 50, 5 local epochs (the last two live in fl/engine.py).  The
update itself (``p - lr * g``) is written out in the client update.
"""

from __future__ import annotations

import numpy as np

PAPER_LR0 = 0.25
PAPER_LR_DECAY = 0.99


def paper_lr(rnd):
    """lr_r = 0.25 * 0.99^r on Python numbers and numpy arrays."""
    return PAPER_LR0 * PAPER_LR_DECAY ** rnd


def round_lrs(n_rounds: int) -> np.ndarray:
    """[R] float32 lr of each round, computed in float64 on the host and
    then cast, so both packages use bit-identical values."""
    return np.float32(paper_lr(np.arange(n_rounds, dtype=np.float64)))
