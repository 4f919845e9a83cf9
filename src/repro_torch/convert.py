"""State and weights carried between the JAX package and the port.

The JAX package's ``bandit_jax.state_tree`` flattens a ``BanditState`` to a
dict of arrays (one run, no grid axis); the engines' ``EnvArrays`` has the
same four fields as the port's; ``models.cnn.init`` gives the CNN's weights
as a nested dict ``{"conv{i}": {"w", "b", "bn_scale", "bn_bias"},
"fc{j}": {"w", "b"}}``; ``models.transformer.init`` gives a dense, moe or
vlm LM's as ``{"embed", "layers", "final_norm"[, "patch_proj"]}``,
``models.griffin.init`` a griffin's as ``{"embed", "groups",
"final_norm", "tail_rec{t}", "tail_mlp{t}"}``, ``models.xlstm.init``
``{"embed", "mlstm", "slstm", "final_norm", "unembed"}`` and
``models.encdec.init`` ``{"enc_layers", "dec_layers", "embed", "unembed",
"enc_norm", "dec_norm"}``.  These functions move such dicts — of numpy
arrays or anything ``np.asarray`` takes — to the port's tensors (and the
CNN's back), so both packages can start from the same mid-run state and
the same model; ``opt_state_from_tree`` carries an optimizer's state
(``optim/sgd.py``) across the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bandit import STATE_FIELDS, BanditState
from repro_torch.sim.engine import EnvArrays


def state_tree(state: BanditState, batched: bool = True) -> dict:
    """The inverse of ``core.bandit.state_from_tree``: a dict of numpy
    arrays, with the [G] axis, or without it
    (``batched=False``; requires G = 1) in the JAX package's layout."""
    out = {name: getattr(state, name).detach().cpu().numpy()
           for name in STATE_FIELDS}
    if not batched:
        if out["n_sel"].shape[0] != 1:
            raise ValueError("batched=False needs a state of one run (G=1)")
        out = {k: v[0] for k, v in out.items()}
    return out


def env_from_tree(tree: dict, device="cpu") -> EnvArrays:
    """The port's :class:`EnvArrays` from the JAX package's fields."""
    def f(x, dtype=np.float32):
        return torch.tensor(np.asarray(x, dtype), device=device)
    return EnvArrays(mean_theta=f(tree["mean_theta"]),
                     mean_gamma=f(tree["mean_gamma"]),
                     n_samples=f(tree["n_samples"]),
                     cell_id=f(tree["cell_id"], np.int64))


def env_tree(env: EnvArrays) -> dict:
    """The inverse of :func:`env_from_tree`, in the JAX package's dtypes."""
    return {"mean_theta": env.mean_theta.cpu().numpy(),
            "mean_gamma": env.mean_gamma.cpu().numpy(),
            "n_samples": env.n_samples.cpu().numpy(),
            "cell_id": env.cell_id.cpu().numpy().astype(np.int32)}


def cnn_params_from_jax(tree: dict, device="cpu") -> dict:
    """The port's CNN parameters (``models/cnn.py`` layout) from the JAX
    package's ``cnn.init`` tree: conv ``w`` HWIO -> OIHW, fc ``w``
    [in, out] -> [out, in].  ``fc0``'s inputs keep their (h, w, c) order,
    which is the order the port flattens in."""
    out = {}
    for layer, leaves in tree.items():
        for leaf, x in leaves.items():
            x = np.asarray(x, np.float32)
            if leaf == "w":
                x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
            out[f"{layer}/{leaf}"] = torch.tensor(np.ascontiguousarray(x),
                                                  device=device)
    return out


def cnn_params_to_jax(params: dict) -> dict:
    """The inverse of :func:`cnn_params_from_jax`: a nested dict of numpy
    arrays in the JAX package's layout."""
    out: dict = {}
    for name, x in params.items():
        layer, leaf = name.split("/")
        x = x.detach().cpu().numpy()
        if leaf == "w":
            x = x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
        out.setdefault(layer, {})[leaf] = np.ascontiguousarray(x)
    return out


def _lm_leaf(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":           # numpy has no bfloat16 of its own
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def lm_params_from_tree(tree: dict, device=None) -> dict:
    """The port's LM parameters from the JAX package's ``init`` tree, as
    numpy arrays or anything ``np.asarray`` takes; any nesting of dicts is
    carried over as it is.  For ``models/transformer.py``: ``embed.tok``
    (and ``embed.unembed`` untied), the [L]-stacked ``layers.{attn_norm,
    mlp_norm, attn.{wq, wk, wv, wo [, q_norm, k_norm]}}`` with
    ``layers.mlp.{w_gate, w_up, w_down}`` (dense) or ``layers.moe.{router,
    w_gate, w_up, w_down [, shared.{w_gate, w_up, w_down}]}`` (moe: experts
    [L, E, D, F] and [L, E, F, D]), ``final_norm``, and a vlm's
    ``patch_proj``.  For ``models/griffin.py``: ``embed.tok``, the
    [G]-stacked ``groups.{rec0, rec1}.{norm, w_x, w_gate, conv, w_r, w_i,
    lam, w_out}``, ``groups.attn.{norm, wq, wkv, wo}``, ``groups.{mlp0,
    mlp1, mlp2}.{norm, w_gate, w_up, w_down}``, the unstacked
    ``tail_rec{t}``/``tail_mlp{t}`` and ``final_norm``.  For
    ``models/xlstm.py``: ``embed.tok``, ``mlstm.{norm, w_up, w_gate, w_q,
    w_k, w_v, w_if, conv, w_down, out_norm}`` stacked [G, 7, ...],
    ``slstm.{norm, w_in, r, ffn_norm, w_ff_gate, w_ff_up, w_ff_down}``
    stacked [G, ...], ``final_norm`` and ``unembed``.  For
    ``models/encdec.py``: ``enc_layers.{attn_norm, attn, mlp_norm, mlp}``
    and ``dec_layers.{self_norm, self_attn, cross_norm, cross_attn,
    mlp_norm, mlp}`` stacked [L], ``embed.tok``, ``unembed``, ``enc_norm``
    and ``dec_norm``.  Same dtypes (bfloat16 kept), same ``[d_in, d_out]``
    layout, so ``x @ w`` reads as in the JAX package."""
    return {k: (lm_params_from_tree(v, device) if isinstance(v, dict)
                else _lm_leaf(v, device))
            for k, v in tree.items()}


def opt_state_from_tree(tree: dict, device=None) -> dict:
    """The port's optimizer state (``optim/sgd.py``) from the JAX package's:
    ``{"step": int32 scalar, "m": tree, "v": tree}`` of ``adamw`` or
    ``{"step"[, "mu": tree]}`` of ``sgd``, as numpy arrays or anything
    ``np.asarray`` takes.  The trees keep their structure, dtypes and
    layout (the LMs' parameter layout, :func:`lm_params_from_tree`), so a
    port optimizer steps on from a JAX run's mid-run state."""
    if "step" not in tree:
        raise ValueError("an optimizer state holds a 'step'")
    return lm_params_from_tree(tree, device)
