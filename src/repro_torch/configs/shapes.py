"""The assigned input-shape set (applies to every architecture) — a copy
of ``repro.configs.shapes``.

  train_4k     seq 4096   x global_batch 256   -> train_step
  prefill_32k  seq 32768  x global_batch 32    -> prefill_step
  decode_32k   seq 32768  x global_batch 128   -> decode_step (1 new token
                                                  against a 32k cache)
  long_500k    seq 524288 x global_batch 1     -> decode_step; sub-quadratic
                                                  archs only (xlstm, griffin)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# archs able to decode at 500k context (bounded state / window)
SUBQUADRATIC = {"xlstm-1.3b", "recurrentgemma-9b"}


def supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: 500k KV cache excluded by spec"
    return True, ""
