"""The port's resumable serving entry point (repro_torch.launch.serve_fl), on
the CPU: a run "crashed" by ``max_segments`` and re-invoked lands bitwise
on the uninterrupted run; a torn newest checkpoint costs one segment; a
directory of only corrupt checkpoints starts fresh; a checkpoint of
another run is refused; ``--fresh`` ignores checkpoints; and a checkpoint
directory of the JAX package's ``serve_fl`` resumes in the port (same run
identity, the device not part of it).
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import serve_fl as jserve_fl  # noqa: E402
from repro.sim import async_engine as jae  # noqa: E402
from repro_torch.checkpoint.ckpt import CheckpointManager  # noqa: E402
from repro_torch.launch import serve_fl  # noqa: E402
from repro_torch.sim import async_engine as ae  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

FIELDS = dict(n_slots=16, buffer_size=3, max_staleness=6, s_dispatch=4,
              n_req=8, arrival_rate=3.0)
KW = dict(ticks=24, segment=8, seed=1, n_clients=30, eta=1.5,
          log=lambda *_: None, device="cpu")
SUMMARY = ("ticks", "sim_time", "admitted", "aggregated", "dropped",
           "failed", "corrupt", "buffered")


@pytest.fixture(scope="module", autouse=True)
def _release_compiled_serving_loops():
    yield
    jax.clear_caches()


def _snap_equal(a, b) -> bool:
    ta, tb = ae.snapshot_tree(a), ae.snapshot_tree(b)
    return all(torch.equal(ta[k], tb[k]) for k in ta if k != "bandit") and \
        all(torch.equal(ta["bandit"][k], tb["bandit"][k])
            for k in ta["bandit"])


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    d = tmp_path_factory.mktemp("straight")
    return serve_fl.run_serving("paper-baseline", "naive_ucb",
                                ckpt_dir=d, cfg=ae.AsyncConfig(**FIELDS),
                                **KW)


def test_crash_then_resume_equals_uninterrupted(tmp_path, straight):
    cfg = ae.AsyncConfig(**FIELDS)
    assert straight["ticks"] == 24
    crashed = serve_fl.run_serving("paper-baseline", "naive_ucb",
                                   ckpt_dir=tmp_path, max_segments=2,
                                   cfg=cfg, **KW)
    assert crashed["ticks"] == 16
    assert CheckpointManager(tmp_path).steps() == [8, 16]
    lines = []
    resumed = serve_fl.run_serving("paper-baseline", "naive_ucb",
                                   ckpt_dir=tmp_path, cfg=cfg,
                                   **{**KW, "log": lines.append})
    assert "resumed from checkpoint step 16 (tick 16)" in lines[0]
    for key in SUMMARY:
        assert resumed[key] == straight[key], key
    assert _snap_equal(resumed["state"], straight["state"])

    with pytest.raises(ValueError, match="different run"):
        serve_fl.run_serving("paper-baseline", "naive_ucb",
                             ckpt_dir=tmp_path, cfg=cfg,
                             **{**KW, "seed": 2})


def test_torn_newest_checkpoint_costs_one_segment(tmp_path, straight):
    cfg = ae.AsyncConfig(**FIELDS)
    serve_fl.run_serving("paper-baseline", "naive_ucb", ckpt_dir=tmp_path,
                         max_segments=2, cfg=cfg, **KW)
    torn = Path(tmp_path) / "ckpt_00000016" / "async_serve.npz"
    torn.write_bytes(torn.read_bytes()[:16])
    lines = []
    with pytest.warns(UserWarning, match="skipping corrupt"):
        resumed = serve_fl.run_serving("paper-baseline", "naive_ucb",
                                       ckpt_dir=tmp_path, cfg=cfg,
                                       **{**KW, "log": lines.append})
    assert "(tick 8)" in lines[0]
    assert _snap_equal(resumed["state"], straight["state"])

    # every checkpoint corrupt: start fresh, still the same run
    for p in Path(tmp_path).glob("ckpt_*/async_serve.npz"):
        p.write_bytes(b"garbage")
    lines.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = serve_fl.run_serving("paper-baseline", "naive_ucb",
                                     ckpt_dir=tmp_path, cfg=cfg,
                                     **{**KW, "log": lines.append})
    assert "starting fresh" in lines[0]
    assert _snap_equal(fresh["state"], straight["state"])


def test_cli_fresh_ignores_checkpoints(tmp_path, capsys):
    argv = ["--device", "cpu", "--ticks", "12", "--segment", "5",
            "--n-clients", "20", "--ckpt-dir", str(tmp_path)]
    serve_fl.main(argv + ["--max-segments", "1"])
    serve_fl.main(argv)
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 5 (tick 5)" in out
    assert "done: 12 ticks" in out
    serve_fl.main(argv + ["--fresh"])
    out = capsys.readouterr().out
    assert "resumed" not in out and "tick 5/12" in out
    assert CheckpointManager(tmp_path).latest_step() == 12


def test_jax_checkpoint_directory_resumes_in_the_port(tmp_path):
    """The JAX package's ``run_serving`` stops after 2 segments; the port's,
    called with the same arguments, accepts the directory's checkpoint as
    its own run (the JAX meta compared as Python scalars) and finishes."""
    jkw = {k: v for k, v in KW.items() if k != "device"}
    jserve_fl.run_serving("diurnal-drift", "elementwise_ucb",
                          ckpt_dir=tmp_path, max_segments=2,
                          cfg=jae.AsyncConfig(**FIELDS), **jkw)
    lines = []
    out = serve_fl.run_serving("diurnal-drift", "elementwise_ucb",
                               ckpt_dir=tmp_path,
                               cfg=ae.AsyncConfig(**FIELDS),
                               **{**KW, "log": lines.append})
    assert "resumed from checkpoint step 16 (tick 16)" in lines[0]
    assert out["ticks"] == 24 and int(out["state"].tick) == 24
    assert out["admitted"] == (out["aggregated"] + out["dropped"]
                               + out["failed"] + out["buffered"])
    with pytest.raises(ValueError):
        serve_fl.run_serving("diurnal-drift", "elementwise_ucb",
                             ckpt_dir=tmp_path, cfg=ae.AsyncConfig(
                                 **{**FIELDS, "tick_dt": 40.0}), **KW)


def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_fl.run_serving(ticks=2, segment=1, log=lambda *_: None)
    assert np.isfinite(serve_fl.run_serving(
        ticks=2, segment=1, log=lambda *_: None, device="cpu")["sim_time"])
