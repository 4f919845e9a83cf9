"""The paper's CIFAR-10 CNN (Sect. IV-B) — the PyTorch port of
``repro.models.cnn`` (``CnnConfig``, ``init``, ``apply``, ``loss_fn``,
``param_count``).

Six 3x3 conv layers (32, 32, 64, 64, 128, 128 channels; ReLU, then
BatchNorm; 2x2 max-pool after convs 1 and 3), then FC 512 -> FC 192 -> FC 10:
4,583,146 parameters, the paper's "approximately 4.6 million".

The model is functional: parameters are a flat ``dict`` of tensors keyed
``conv{i}/{w,b,bn_scale,bn_bias}`` and ``fc{j}/{w,b}``, so that
``torch.func.vmap`` and ``torch.func.grad`` run one step of many clients'
models at once.  Layouts are PyTorch's: conv ``w`` is OIHW, fc ``w`` is
[out, in].  Inside, activations are NCHW; before ``fc0`` they are flattened
in NHWC order, as the JAX package does, so ``fc0``'s inputs are in
(h, w, c) order and weights carried across by ``repro_torch.convert`` mean
the same thing in both packages.  BatchNorm always uses the batch's own
statistics (population variance), written as the JAX package writes it:
``scale * (x - mean) * rsqrt(var + eps) + bias``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

CONV_CHANNELS = (32, 32, 64, 64, 128, 128)
POOL_AFTER = (1, 3)          # conv indices followed by a 2x2 max-pool
FC_UNITS = (512, 192)
N_CLASSES = 10
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    image_size: int = 32
    channels: tuple = CONV_CHANNELS
    pool_after: tuple = POOL_AFTER
    fc_units: tuple = FC_UNITS
    n_classes: int = N_CLASSES
    bn_momentum: float = 0.99
    batchnorm: bool = True


def param_shapes(cfg: CnnConfig = CnnConfig()) -> dict[str, tuple]:
    """Every parameter's name and shape, in the port's layout and order."""
    shapes: dict[str, tuple] = {}
    c_in = 3
    for i, c_out in enumerate(cfg.channels):
        shapes[f"conv{i}/w"] = (c_out, c_in, 3, 3)
        for leaf in ("b", "bn_scale", "bn_bias"):
            shapes[f"conv{i}/{leaf}"] = (c_out,)
        c_in = c_out
    n_pools = sum(1 for i in cfg.pool_after if i < len(cfg.channels))
    spatial = cfg.image_size // (2 ** n_pools)
    dims = ((spatial * spatial * (cfg.channels[-1] if cfg.channels else 3),)
            + tuple(cfg.fc_units) + (cfg.n_classes,))
    for j in range(len(dims) - 1):
        shapes[f"fc{j}/w"] = (dims[j + 1], dims[j])
        shapes[f"fc{j}/b"] = (dims[j + 1],)
    return shapes


def init(gen: torch.Generator,
         cfg: CnnConfig = CnnConfig()) -> dict[str, torch.Tensor]:
    """He-normal weights (std sqrt(2 / fan_in)) drawn from ``gen``, zero
    biases, BatchNorm scale 1 and bias 0, on ``gen``'s device."""
    device = gen.device
    params = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.split("/")[1]
        if leaf == "w":
            fan_in = math.prod(shape[1:])
            params[name] = torch.randn(shape, generator=gen, device=device) \
                * math.sqrt(2.0 / fan_in)
        elif leaf == "bn_scale":
            params[name] = torch.ones(shape, device=device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def _batchnorm(x, scale, bias, eps=BN_EPS):
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), correction=0, keepdim=True)
    return (scale.view(1, -1, 1, 1) * (x - mean) * torch.rsqrt(var + eps)
            + bias.view(1, -1, 1, 1))


def forward(params: dict, x: torch.Tensor,
            cfg: CnnConfig = CnnConfig()) -> torch.Tensor:
    """NCHW images [B, 3, H, W] -> logits [B, n_classes]."""
    for i in range(len(cfg.channels)):
        x = F.conv2d(x, params[f"conv{i}/w"], padding=1)
        x = torch.relu(x + params[f"conv{i}/b"].view(1, -1, 1, 1))
        if cfg.batchnorm:
            x = _batchnorm(x, params[f"conv{i}/bn_scale"],
                           params[f"conv{i}/bn_bias"])
        if i in cfg.pool_after:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # (h, w, c) order
    n_fc = len(cfg.fc_units) + 1
    for j in range(n_fc):
        x = x @ params[f"fc{j}/w"].T + params[f"fc{j}/b"]
        if j < n_fc - 1:
            x = torch.relu(x)
    return x


def apply(params: dict, images: torch.Tensor,
          cfg: CnnConfig = CnnConfig()) -> torch.Tensor:
    """NHWC images [B, H, W, 3] (the JAX package's layout) -> logits."""
    return forward(params, images.permute(0, 3, 1, 2), cfg)


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor,
            cfg: CnnConfig = CnnConfig()) -> torch.Tensor:
    """Mean negative log-likelihood of labels ``y`` under the softmax of the
    logits of NCHW images ``x``."""
    logp = torch.log_softmax(forward(params, x, cfg), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def param_count(params: dict) -> int:
    return sum(p.numel() for p in params.values())

