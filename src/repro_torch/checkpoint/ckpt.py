"""Atomic on-disk checkpoints — the PyTorch port of
``repro.checkpoint.ckpt``, in the same layout.

A checkpoint of step s is a directory ``ckpt_%08d`` holding one
``<key>.npz`` per key of the saved dict (its tree's leaves as ``leaf_i``)
and a ``manifest.json`` with ``step``, ``keys`` (per key ``n_leaves``,
``dtypes`` and ``treedef``), ``metadata`` and a SHA-256 per payload file
(``checksums``).  Writes go to ``.tmp_ckpt_%08d``; every file is fsynced,
``os.replace`` publishes the directory and the parent is fsynced, so a
crash mid-save leaves an ignored temporary directory, never a torn
checkpoint.  :meth:`CheckpointManager.restore` verifies the checksums and
falls back to the newest valid checkpoint, warning about the corrupt ones
it skips.  Retention: the ``keep_last`` newest and every
``keep_every``-th.  :func:`bandit_state_tree` / :func:`restore_bandit_state`
carry the host-loop server's ``ClientStats`` and :func:`rng_state_tree` /
:func:`restore_rng` a ``numpy`` generator, so ``launch/train.py`` resumes
where it stopped.

A tree is flattened as ``jax.tree.flatten`` flattens it: dict keys in
sorted order, ``None`` an empty node that leaves no leaf, and everything
else a leaf (a string a 0-d unicode array).  Leaves may be tensors on any
device, numpy arrays or Python scalars.  bfloat16 and float8 tensors are
stored as a uint16 / uint8 view tagged with their dtype's name, as the JAX
package stores them, and restored as CPU tensors of that dtype (numpy has
no such dtype); every other leaf is restored as a numpy array.

The port writes the tree's structure into the manifest as JSON (``treedef``:
a dict node is an object in sorted key order, a leaf ``"*"``, None
``null``) and no ``treedefs.pkl``.  A checkpoint of the JAX package stores
its structure only as a pickle of JAX objects, which this module never
loads: restoring one takes a template of each key's tree
(``restore(like=...)``), whose flattening must give the manifest's leaf
count and dtypes.  The other direction — the JAX package restoring a
checkpoint written here — is not supported: it would need the pickle.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch


LEAF = "*"
# tensor dtypes numpy cannot store: kept as an unsigned view of their width
_WIDE_VIEW = {torch.bfloat16: (np.uint16, torch.uint16),
              torch.float8_e4m3fn: (np.uint8, torch.uint8),
              torch.float8_e5m2: (np.uint8, torch.uint8)}
_WIDE_BY_NAME = {str(t).removeprefix("torch."): t for t in _WIDE_VIEW}


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_file(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a storable numpy array and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype in _WIDE_VIEW:
            name = str(leaf.dtype).removeprefix("torch.")
            return leaf.view(_WIDE_VIEW[leaf.dtype][1]).numpy(), name
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str):
    if dtype_name in _WIDE_BY_NAME:
        return torch.from_numpy(arr).view(_WIDE_BY_NAME[dtype_name])
    return arr


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, structure)`` of a tree, leaves in ``jax.tree.flatten``'s
    order; the structure is JSON (:data:`LEAF` for a leaf)."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        leaves, struct = [], {}
        for key in sorted(tree):
            sub, struct[key] = flatten(tree[key])
            leaves += sub
        return leaves, struct
    if isinstance(tree, (list, tuple)):
        raise TypeError("checkpoint trees are dicts of leaves; got a "
                        f"{type(tree).__name__}")
    return [tree], LEAF


def unflatten(structure: Any, leaves: list) -> Any:
    """The inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == LEAF:
            return next(it)
        return {key: build(sub) for key, sub in s.items()}
    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _dtypes_match(saved: str, like) -> bool:
    """A template leaf fits a saved dtype: the same dtype, or both strings
    (a string's dtype names its length)."""
    want = _to_numpy(like)[1]
    if saved in _WIDE_BY_NAME or want in _WIDE_BY_NAME:
        return saved == want
    return saved == want or np.dtype(saved).kind == np.dtype(want).kind == "U"


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3,
                 keep_every: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_every = keep_every

    # ------------------------------------------------------------------
    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:08d}"

    def save(self, step: int, state: dict[str, Any],
             metadata: dict | None = None) -> Path:
        """``state``: a dict of trees (params, optimizer state, bandit,
        ...), one ``.npz`` each."""
        tmp = self.dir / f".tmp_ckpt_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: dict[str, Any] = {"step": step, "keys": {},
                                    "metadata": metadata or {}}
        for key, tree in state.items():
            leaves, structure = flatten(tree)
            stored = [_to_numpy(leaf) for leaf in leaves]
            np.savez(tmp / f"{key}.npz",
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(stored)})
            manifest["keys"][key] = {
                "n_leaves": len(leaves),
                "dtypes": [name for _, name in stored],
                "treedef": structure,
            }
        manifest["checksums"] = {
            p.name: _sha256(p) for p in sorted(tmp.iterdir())
            if p.name != "manifest.json"}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        # durability before visibility: flush every payload byte, publish
        # the directory atomically, then persist the rename itself
        for p in tmp.iterdir():
            _fsync_file(p)
        _fsync_file(tmp)
        final = self._path(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _fsync_file(self.dir)
        self._gc()
        return final

    def is_valid(self, step: int) -> bool:
        """True iff checkpoint ``step`` is structurally complete and every
        payload file matches its manifest SHA-256 (checkpoints without
        checksums pass if their files are present)."""
        path = self._path(step)
        try:
            manifest = json.loads((path / "manifest.json").read_text())
            if int(manifest["step"]) != step:
                return False
            checksums = manifest.get("checksums")
            if checksums is None:
                return all((path / f"{k}.npz").exists()
                           for k in manifest["keys"])
            return all((path / name).exists()
                       and _sha256(path / name) == digest
                       for name, digest in checksums.items())
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return False

    def restore(self, step: int | None = None,
                like: dict[str, Any] | None = None
                ) -> tuple[int, dict[str, Any]]:
        """Load a checkpoint.  With ``step=None``, walk newest -> oldest and
        load the first whose checksums verify, warning about each corrupt
        one skipped.  ``like`` maps keys to template trees: a key whose
        manifest holds no structure (a JAX package checkpoint) is rebuilt
        on its template after its leaf count and dtypes are checked."""
        if step is None:
            for cand in reversed(self.steps()):
                if self.is_valid(cand):
                    step = cand
                    break
                warnings.warn(f"skipping corrupt checkpoint ckpt_{cand:08d} "
                              f"in {self.dir} (checksum/structure mismatch)")
            if step is None:
                raise FileNotFoundError(f"no valid checkpoints in {self.dir}")
        elif not self.is_valid(step):
            raise ValueError(f"checkpoint ckpt_{step:08d} in {self.dir} is "
                             f"corrupt (checksum/structure mismatch)")
        path = self._path(step)
        manifest = json.loads((path / "manifest.json").read_text())
        state = {}
        for key, info in manifest["keys"].items():
            with np.load(path / f"{key}.npz") as z:
                leaves = [_from_numpy(z[f"leaf_{i}"], info["dtypes"][i])
                          for i in range(info["n_leaves"])]
            structure = info["treedef"]
            if str(structure).startswith("PyTreeDef"):   # the JAX package's
                structure = self._template(key, info, like, path)
            state[key] = unflatten(structure, leaves)
        return manifest["step"], state

    @staticmethod
    def _template(key: str, info: dict, like, path: Path):
        if like is None or key not in like:
            raise ValueError(
                f"{path} stores the structure of {key!r} only as a pickle "
                "of JAX objects; pass a template tree as like={key: ...}")
        leaves, structure = flatten(like[key])
        if len(leaves) != info["n_leaves"] or not all(
                _dtypes_match(d, leaf)
                for d, leaf in zip(info["dtypes"], leaves)):
            raise ValueError(
                f"{path}: {key!r} holds {info['n_leaves']} leaves of "
                f"{info['dtypes']}, the template {len(leaves)} of "
                f"{[_to_numpy(x)[1] for x in leaves]}")
        return structure

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "ckpt_*") if p.is_dir())

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def latest_valid_step(self) -> int | None:
        """Newest step whose checkpoint verifies (None when none do)."""
        for s in reversed(self.steps()):
            if self.is_valid(s):
                return s
        return None

    def _gc(self) -> None:
        steps = self.steps()
        if len(steps) <= self.keep_last:
            return
        for s in steps[:-self.keep_last]:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self._path(s), ignore_errors=True)


def bandit_state_tree(stats) -> dict:
    """``core/host_bandit.ClientStats`` -> a checkpointable tree."""
    return {
        "n_sel": stats.n_sel, "sum_ud": stats.sum_ud, "sum_ul": stats.sum_ul,
        "sum_tinc": stats.sum_tinc, "last_ud": stats.last_ud,
        "last_ul": stats.last_ul, "hist_ud": stats.hist_ud,
        "hist_ul": stats.hist_ul, "hist_n": stats.hist_n,
        "total_sel": np.asarray(stats.total_sel),
    }


def restore_bandit_state(stats, tree: dict) -> None:
    """The inverse of :func:`bandit_state_tree`, into ``stats`` in place."""
    for k in ("n_sel", "sum_ud", "sum_ul", "sum_tinc", "last_ud", "last_ul",
              "hist_ud", "hist_ul", "hist_n"):
        getattr(stats, k)[...] = tree[k]
    stats.total_sel = int(tree["total_sel"])


def rng_state_tree(rng: np.random.Generator) -> dict:
    """A ``numpy`` generator's state as a checkpointable tree (one string
    leaf: its 128-bit integers do not fit an integer array)."""
    return {"state": json.dumps(rng.bit_generator.state)}


def restore_rng(rng: np.random.Generator, tree: dict) -> None:
    """The inverse of :func:`rng_state_tree`, into ``rng`` in place."""
    rng.bit_generator.state = json.loads(str(tree["state"]))
