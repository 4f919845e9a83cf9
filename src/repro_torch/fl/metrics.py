"""Learning-coupled evaluation metrics (paper Figs. 4-6) — the port's numpy
copy of ``repro.fl.metrics``.

  * ``time_to_accuracy`` — ToA@x: the first elapsed time at which the test
    accuracy reaches a target;
  * ``accuracy_at_time`` — the accuracy-vs-time step curve resampled onto a
    common time grid;
  * ``final_accuracy`` — the mean over the last rounds;
  * ``toa_table`` — a printable ToA@x summary over a policy axis.

Host-side numpy over the traces the engine returns; every function
broadcasts over leading axes ([policy, seed, round] stacks).
"""

from __future__ import annotations

import numpy as np


def time_to_accuracy(elapsed: np.ndarray, accuracy: np.ndarray,
                     target: float) -> np.ndarray:
    """ToA@target over [..., R] traces: the elapsed time of the first round
    whose test accuracy reaches ``target`` (np.inf when never reached)."""
    elapsed = np.asarray(elapsed, np.float64)
    accuracy = np.asarray(accuracy, np.float64)
    hit = accuracy >= target
    first = hit.argmax(axis=-1)                    # 0 when no hit: masked
    t = np.take_along_axis(elapsed, first[..., None], axis=-1)[..., 0]
    return np.where(hit.any(axis=-1), t, np.inf)


def accuracy_at_time(elapsed: np.ndarray, accuracy: np.ndarray,
                     t_grid: np.ndarray) -> np.ndarray:
    """Resample [..., R] traces onto ``t_grid`` [T] as a step function: the
    accuracy of the last round completed by each grid time (0.0 before the
    first round finishes).  Returns [..., T]."""
    elapsed = np.asarray(elapsed, np.float64)
    accuracy = np.asarray(accuracy, np.float64)
    t_grid = np.asarray(t_grid, np.float64)
    done = np.apply_along_axis(
        lambda e: np.searchsorted(e, t_grid, side="right"), -1, elapsed)
    acc0 = np.concatenate([np.zeros(accuracy.shape[:-1] + (1,)), accuracy],
                          axis=-1)
    return np.take_along_axis(acc0, done, axis=-1)


def final_accuracy(accuracy: np.ndarray, window: int = 1) -> np.ndarray:
    """Mean accuracy over the last ``window`` rounds of [..., R] traces."""
    return np.asarray(accuracy, np.float64)[..., -window:].mean(axis=-1)


def toa_table(policies: list[str], elapsed: np.ndarray, accuracy: np.ndarray,
              targets: tuple[float, ...] = (0.5, 0.7, 0.8)) -> str:
    """Seed-averaged ToA@x lines, one per policy.  ``elapsed``/``accuracy``
    are [P, S, R]; a seed that never reaches a target makes its mean inf."""
    rows = [f"{'policy':>16} | " + " | ".join(f"ToA@{t:.0%}".rjust(10)
                                              for t in targets)]
    for i, name in enumerate(policies):
        cells = []
        for t in targets:
            toa = time_to_accuracy(elapsed[i], accuracy[i], t).mean()
            cells.append(f"{toa:10.0f}" if np.isfinite(toa) else
                         " " * 7 + "inf")
        rows.append(f"{name:>16} | " + " | ".join(cells))
    return "\n".join(rows)
