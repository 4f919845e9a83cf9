"""The port's checkpoints (repro_torch.checkpoint.ckpt) and the bandit
state's trees, on the CPU: round trips (a bfloat16 leaf included),
retention, atomicity, the fallback past a torn or bit-flipped newest
checkpoint, and a checkpoint written by the JAX package's
``CheckpointManager`` restored without unpickling anything of JAX and
continued by the port to the JAX package's own result.

Tolerances: as tests/test_torch_async_engine.py (traces and integer
state exact, float state rtol 1e-6).
"""

import dataclasses
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_parity import (async_trees_match, jax_tick_draws,  # noqa: E402
                           jax_tree, mid_run_tree)

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import bandit_jax  # noqa: E402
from repro.sim import async_engine as jae  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import bandit  # noqa: E402
from repro_torch.sim import async_engine as ae  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_serving_loops():
    yield
    jax.clear_caches()


@pytest.fixture
def state():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "b": torch.linspace(-1, 1, 5).to(torch.bfloat16)},
        "opt": {"step": np.asarray(7), "m": {"w": torch.zeros(3, 4)},
                "unused": None},
        "rng": np.asarray([12345, 678], np.uint64),
        "meta": {"scenario": "paper-baseline", "eta": 1.5, "fresh": True},
    }


def test_roundtrip_keeps_values_dtypes_and_structure(tmp_path, state):
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, state, metadata={"note": "test"})
    step, got = mgr.restore()
    assert step == 5
    b = got["params"]["b"]
    assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16
    assert torch.equal(b, state["params"]["b"])
    np.testing.assert_array_equal(got["params"]["w"], np.arange(12.0)
                                  .reshape(3, 4))
    assert got["params"]["w"].dtype == np.float32
    assert got["opt"]["unused"] is None and int(got["opt"]["step"]) == 7
    assert got["rng"].dtype == np.uint64
    assert got["meta"]["scenario"].item() == "paper-baseline"
    manifest = json.loads((tmp_path / "ckpt_00000005" /
                           "manifest.json").read_text())
    assert manifest["metadata"] == {"note": "test"}
    assert manifest["keys"]["params"]["dtypes"] == ["bfloat16", "float32"]
    assert manifest["keys"]["opt"]["treedef"] == {
        "m": {"w": "*"}, "step": "*", "unused": None}
    assert set(manifest["checksums"]) == {f"{k}.npz" for k in state}
    assert not (tmp_path / "ckpt_00000005" / "treedefs.pkl").exists()


def test_flatten_orders_leaves_as_jax_does(state):
    tree = {k: v for k, v in state.items() if k != "rng"}
    leaves, _ = ckpt.flatten(tree)
    want = jax.tree.leaves(jax.tree.map(
        lambda x: x, {**tree, "params": {"w": 0, "b": 1}}))
    assert len(leaves) == len(want)
    assert [str(x) for x in ckpt.flatten(tree["meta"])[0]] == [
        str(x) for x in jax.tree.leaves(tree["meta"])]
    with pytest.raises(TypeError):
        ckpt.flatten({"a": [1, 2]})


def test_retention(tmp_path, state):
    mgr = CheckpointManager(tmp_path, keep_last=2, keep_every=10)
    for s in [1, 5, 10, 11, 12]:
        mgr.save(s, state)
    assert mgr.steps() == [10, 11, 12]


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=5)
    mgr.save(1, {"params": {"x": torch.tensor(1.0)}})
    mgr.save(2, {"params": {"x": torch.tensor(2.0)}})
    step, got = mgr.restore(1)
    assert step == 1 and float(got["params"]["x"]) == 1.0


def test_no_partial_checkpoints_and_missing_raises(tmp_path, state):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    (tmp_path / ".tmp_ckpt_00000099").mkdir()
    mgr.save(1, state)
    assert mgr.steps() == [1] and mgr.latest_step() == 1


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_corrupt_newest_falls_back_to_older_valid(tmp_path, damage):
    mgr = CheckpointManager(tmp_path, keep_last=5)
    for step in (1, 2, 3):
        mgr.save(step, {"x": {"a": np.arange(step + 10)}})
    target = Path(tmp_path) / "ckpt_00000003" / "x.npz"
    raw = bytearray(target.read_bytes())
    if damage == "truncate":
        raw = raw[:8]
    else:
        raw[len(raw) // 2] ^= 0x10
    target.write_bytes(bytes(raw))
    assert not mgr.is_valid(3) and mgr.latest_valid_step() == 2
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        step, got = mgr.restore()
    assert step == 2
    np.testing.assert_array_equal(got["x"]["a"], np.arange(12))
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(3)


def test_bandit_state_survives_with_every_field(tmp_path):
    tree = mid_run_tree(np.random.default_rng(3), 9)
    state = bandit.state_from_tree(tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save(4, {"bandit": bandit.state_tree(state)})
    _, got = mgr.restore()
    back = bandit.state_from_tree(got["bandit"])
    for name in bandit.STATE_FIELDS:
        assert torch.equal(getattr(back, name), getattr(state, name)), name


def test_state_trees_match_the_jax_package():
    """``state_tree`` of a G = 1 state has JAX's names, shapes and dtypes;
    a JAX tree (with or without ``n_fail``) restores as G = 1; a G > 1
    state keeps its grid axis; ``cand_idx_from_mask`` is JAX's."""
    jstate = bandit_jax.BanditState.create(7)
    want = jax_tree(jstate)
    got = bandit.state_tree(bandit.BanditState.create(1, 7))
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype)
    tree = mid_run_tree(np.random.default_rng(0), 7)
    old = {k: v for k, v in tree.items() if k != "n_fail"}
    restored = bandit.state_from_tree(old)
    assert restored.n_sel.shape == (1, 7)
    assert torch.equal(restored.n_fail, torch.zeros(1, 7, dtype=torch.int32))
    jback = bandit_jax.state_from_tree(old)
    np.testing.assert_array_equal(np.asarray(jback.n_fail),
                                  restored.n_fail[0].numpy())
    assert bandit.state_tree(bandit.BanditState.create(3, 7))[
        "n_sel"].shape == (3, 7)

    rng = np.random.default_rng(1)
    for k, size in ((20, 6), (20, 20), (5, 8)):
        mask = rng.random(k) < 0.3
        want = np.asarray(bandit_jax.cand_idx_from_mask(jnp.asarray(mask),
                                                        size))
        got = bandit.cand_idx_from_mask(torch.from_numpy(mask), size)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package serves 11 of 24 ticks and saves its snapshot through
    its own CheckpointManager; the port restores it on a template of its
    own snapshot (the pickled treedefs untouched), continues on JAX's draws
    of ticks 11..23 and lands on JAX's uninterrupted run."""
    scen, policy, k, seed, total, split = ("diurnal-drift", "discounted_ucb",
                                           40, 5, 24, 11)
    fields = dict(n_slots=16, buffer_size=3, max_staleness=6, s_dispatch=4,
                  n_req=8, arrival_rate=3.0)
    jcfg, cfg = jae.AsyncConfig(**fields), ae.AsyncConfig(**fields)
    kw = dict(seed=seed, total_ticks=total, n_clients=k, eta=1.5)
    full = jae.serve(scen, policy, n_ticks=total, cfg=jcfg, **kw)
    part = jae.serve(scen, policy, n_ticks=split, cfg=jcfg, **kw)
    jckpt.CheckpointManager(tmp_path).save(split, {
        "async_serve": jax.device_get(jae.snapshot_tree(part.state))})
    assert (tmp_path / f"ckpt_{split:08d}" / "treedefs.pkl").exists()

    mgr = CheckpointManager(tmp_path)
    with pytest.raises(ValueError, match="template"):
        mgr.restore()
    env = ae.sim.EnvArrays.from_scenario(
        ae.get_scenario(scen), ae.get_scenario(scen).build_env(
            k, np.random.default_rng(0)))
    like = {"async_serve": ae.snapshot_tree(ae.AsyncState.create(env, cfg))}
    step, snap = mgr.restore(like=like)
    assert step == split
    state = ae.state_from_snapshot(snap["async_serve"], "cpu")
    async_trees_match(state, part.state, 0.0, "restored")

    draws = jax_tick_draws(scen, jcfg, seed, total, k)[split:]
    rest = ae.serve(scen, policy, n_ticks=total - split, t0=split,
                    state=state, cfg=cfg, env=env, draws=draws,
                    device="cpu", **kw)
    for name in ("selected", "aggregated", "dropped", "buffered"):
        np.testing.assert_array_equal(getattr(rest, name),
                                      getattr(full, name)[split:], name)
    np.testing.assert_allclose(rest.elapsed, full.elapsed[split:],
                               rtol=1e-6, atol=0)
    async_trees_match(rest.state, full.state, 1e-6, "continued")

    # a template of another shape is refused before any leaf is filled
    small = {"async_serve": ae.snapshot_tree(ae.AsyncState.create(
        env, dataclasses.replace(cfg, n_slots=8)))}
    bad = {"async_serve": {**small["async_serve"], "extra": np.zeros(1)}}
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(like=bad)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mgr.restore(like=like)
