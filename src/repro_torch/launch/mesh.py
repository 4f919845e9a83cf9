"""Device meshes over ``torch.distributed`` ranks — the port of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group, one card a rank, with the JAX package's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` with a pod
axis.  :func:`make_mesh` builds one and needs the process group (torchrun,
or ``init_process_group`` with an address, world size and rank);
:func:`production_shapes` gives the axis sizes of the JAX package's
production meshes (16 x 16 and 2 x 16 x 16), which the dry run
(launch/dryrun.py) lays over a fake process group of that many ranks.
The JAX module's ``batch_axes`` is ``distributed/sharding.batch_axes``
here, beside the spec rules that use it.  Nothing here touches a process
group at import.
"""

from __future__ import annotations

import math

import torch.distributed as dist


def production_shapes() -> dict[str, dict[str, int]]:
    """{mesh name: {axis: size}} of the JAX package's production meshes:
    one pod of 16 x 16 = 256 chips, and 2 pods of 16 x 16."""
    return {"16x16": {"data": 16, "model": 16},
            "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def parse_mesh(text: str) -> dict[str, int]:
    """"DxM" (or "PxDxM") -> {axis: size}, e.g. "1x4" = 1 data x 4 model."""
    parts = [int(p) for p in text.lower().split("x")]
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(parts))
    if names is None or min(parts) < 1:
        raise ValueError(f"a mesh is DxM or PxDxM, got {text!r}")
    return dict(zip(names, parts))


def make_mesh(data: int, model: int, *, pod: int | None = None,
              device_type: str = "cuda"):
    """The mesh ``(data, model)`` (``(pod, data, model)`` with ``pod``) over
    the default process group, whose world size must be its size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (data, model) if pod is None else (pod, data, model)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(torchrun, or init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)
