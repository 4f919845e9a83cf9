"""Architecture registry: ``--arch <id>`` -> a uniform :class:`ModelApi` —
the port of ``repro.models.registry``.

  init(generator, keep=whole)             -> params
  forward(params, batch)                  -> (logits, aux)
  loss_fn(params, batch)                  -> scalar
  prefill(params, batch, max_len=None)    -> (last_logits, cache, pos)
  decode_step(params, cache, tokens, pos) -> (logits, cache)
  input_specs(shape)                      -> batch on the meta device
  decode_state_specs(shape)               -> cache on the meta device
  supports(shape)                         -> (ok, reason)
  param_counts()                          -> (total, active)

``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` take ``mp=`` (a
``layers.ModelParallel``) for one rank of a device mesh.  ``ARCH_MODULES``
lists every architecture of the JAX package, each with its config in
``repro_torch.configs`` and its family's model code.  A shape is a name of
``configs.shapes.SHAPES`` (a (config, shape) pair is a dry-run cell,
launch/dryrun.py); the ``meta`` tensors carry shapes and dtypes and no
storage, as ``jax.eval_shape``'s structs do.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable

import torch

from repro_torch.configs.shapes import SHAPES, ShapeCell, supported
from repro_torch.models.layers import LMConfig, init_kv_cache
from repro_torch.utils.trees import tree_leaves

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

FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.transformer",
    "vlm": "repro_torch.models.transformer",
    "xlstm": "repro_torch.models.xlstm",
    "griffin": "repro_torch.models.griffin",
    "encdec": "repro_torch.models.encdec",
}


class _ShapeGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device, so an ``init``
    that allocates on ``generator.device`` builds shapes only: nothing is
    drawn and nothing is allocated."""
    device = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ModelApi:
    name: str
    cfg: LMConfig
    init: Callable
    forward: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable

    def input_specs(self, shape: str) -> dict:
        """The batch of a cell of ``shape`` on the meta device."""
        return _lm_input_specs(self.cfg, SHAPES[shape])

    def decode_state_specs(self, shape: str):
        """The decode cache / recurrent states of a cell of ``shape`` on the
        meta device (no allocation)."""
        return _decode_state_specs(self.cfg, SHAPES[shape])

    def supports(self, shape: str) -> tuple[bool, str]:
        return supported(self.name, shape)

    def param_shapes(self) -> dict:
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        no storage (the full kimi-k2 counts on any machine); built once
        per model API and shared, so callers must not change it."""
        return _param_shapes(self)

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameter counts, as the JAX package computes
        them: with MoE, ``active`` keeps top_k / n_experts of the routed
        experts' weights (the shared expert and the router count whole)."""
        shapes = self.param_shapes()
        total = sum(x.numel() for x in tree_leaves(shapes))
        active = total
        mc = self.cfg.moe
        if mc is not None:
            moe = shapes["layers"]["moe"]
            expert = sum(moe[k].numel() for k in ("w_gate", "w_up", "w_down"))
            active = total - expert + int(expert * mc.top_k / mc.n_experts)
        return total, active


@functools.lru_cache(maxsize=32)
def _param_shapes(api: ModelApi) -> dict:
    return api.init(_ShapeGenerator())


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_input_specs(cfg: LMConfig, cell: ShapeCell) -> dict:
    """A cell's inputs as the JAX package's ``_lm_input_specs`` shapes them:
    decode takes ``tokens`` [B]; a vlm's prefill/train batch S - n_patches
    text tokens and [B, n_patches, patch_embed_dim] bfloat16 patches; an
    enc-dec's S/2 bfloat16 frames of d_model and S/2 tokens."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "decode":
        return {"tokens": _meta((b,), torch.int32)}
    if cfg.family == "vlm":
        text = s - cfg.n_patches
        if text <= 0:
            raise ValueError(f"{cfg.name} x {cell.name}: no text positions")
        return {"tokens": _meta((b, text), torch.int32),
                "patch_embeds": _meta((b, cfg.n_patches,
                                       cfg.patch_embed_dim), torch.bfloat16)}
    if cfg.family == "encdec":
        half = s // 2
        return {"frames": _meta((b, half, cfg.d_model), torch.bfloat16),
                "tokens": _meta((b, half), torch.int32)}
    return {"tokens": _meta((b, s), torch.int32)}


def _decode_state_specs(cfg: LMConfig, cell: ShapeCell):
    b, s = cell.global_batch, cell.seq_len
    if cfg.family in ("dense", "moe", "vlm"):
        return init_kv_cache(cfg, b, s, layers_dim=cfg.n_layers,
                             device="meta")
    if cfg.family in ("xlstm", "griffin"):
        fam = importlib.import_module(FAMILY_MODULES[cfg.family])
        return fam.init_states(cfg, b, device="meta")
    if cfg.family == "encdec":
        from repro_torch.configs.seamless_m4t_medium import ENC_STUB_LEN
        return {"self": init_kv_cache(cfg, b, s, layers_dim=cfg.n_layers,
                                      device="meta"),
                "enc_out": _meta((b, ENC_STUB_LEN, cfg.d_model),
                                 cfg.compute_dtype)}
    raise ValueError(cfg.family)


@functools.lru_cache(maxsize=None)
def build(arch: str, reduced: bool = False,
          n_layers: int | None = None) -> ModelApi:
    """The model API of ``arch`` (its ``REDUCED`` config with ``reduced``);
    ``n_layers`` cuts the depth (decoder layers for enc-dec, a multiple of
    8 for xlstm) and keeps every width: a full-width model that one card
    cannot hold whole."""
    if arch not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; one of {list(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    cfg: LMConfig = mod.REDUCED if reduced else mod.CONFIG
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    fam = importlib.import_module(FAMILY_MODULES[cfg.family])
    return ModelApi(
        name=arch, cfg=cfg,
        init=functools.partial(fam.init, cfg=cfg),
        forward=functools.partial(fam.forward, cfg=cfg),
        loss_fn=functools.partial(fam.loss_fn, cfg=cfg),
        prefill=functools.partial(fam.prefill, cfg=cfg),
        decode_step=functools.partial(fam.decode_step, cfg=cfg),
    )


def list_archs() -> list[str]:
    return list(ARCH_MODULES)
