"""Architecture registry: ``--arch <id>`` -> a uniform :class:`ModelApi` —
the port of ``repro.models.registry`` for the dense and griffin families.

  init(generator)                         -> params
  forward(params, batch)                  -> (logits, aux)
  loss_fn(params, batch)                  -> scalar
  prefill(params, batch, max_len=None)    -> (last_logits, cache, pos)
  decode_step(params, cache, tokens, pos) -> (logits, cache)

``ARCH_MODULES`` lists every architecture of the JAX package; only the
dense ones and recurrentgemma-9b (griffin) have configs and model code in
the port so far, and building any other raises ``NotImplementedError``
naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable

from repro_torch.models.layers import LMConfig

ARCH_MODULES = {
    "yi-9b": "yi_9b",
    "qwen3-1.7b": "qwen3_1_7b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "smollm-135m": "smollm_135m",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "kimi-k2-1t-a32b": "kimi_k2",
    "llava-next-34b": "llava_next_34b",
    "xlstm-1.3b": "xlstm_1_3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_FAMILIES = {
    "yi-9b": "dense", "qwen3-1.7b": "dense", "codeqwen1.5-7b": "dense",
    "smollm-135m": "dense", "phi3.5-moe-42b-a6.6b": "moe",
    "kimi-k2-1t-a32b": "moe", "llava-next-34b": "vlm",
    "xlstm-1.3b": "xlstm", "seamless-m4t-medium": "encdec",
    "recurrentgemma-9b": "griffin",
}

FAMILY_MODULES = {"dense": "repro_torch.models.transformer",
                  "griffin": "repro_torch.models.griffin"}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    name: str
    cfg: LMConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable


@functools.lru_cache(maxsize=None)
def build(arch: str, reduced: bool = False) -> ModelApi:
    if arch not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; one of {list(ARCH_MODULES)}")
    family = ARCH_FAMILIES[arch]
    if family not in FAMILY_MODULES:
        raise NotImplementedError(
            f"{arch}: the {family} family is not ported yet (ROADMAP Queue 1 "
            f"item 5)")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    cfg: LMConfig = mod.REDUCED if reduced else mod.CONFIG
    fam = importlib.import_module(FAMILY_MODULES[family])
    return ModelApi(
        name=arch, cfg=cfg,
        init=lambda generator: fam.init(generator, cfg),
        forward=functools.partial(fam.forward, cfg=cfg),
        loss_fn=functools.partial(fam.loss_fn, cfg=cfg),
        prefill=functools.partial(fam.prefill, cfg=cfg),
        decode_step=functools.partial(fam.decode_step, cfg=cfg),
    )


def list_archs() -> list[str]:
    return list(ARCH_MODULES)
