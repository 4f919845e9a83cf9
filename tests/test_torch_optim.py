"""The port's optimizers (``optim/sgd.py``) against the JAX package's on
random nested parameter trees: ``sgd`` with and without momentum (and
Nesterov), ``adamw`` with and without weight decay, both schedules, from a
zero state and from a mid-run state carried across by
``convert.opt_state_from_tree``.  Tolerance: rtol 1e-6 (atol 1e-7 for
values that pass through 0) on parameters, moments and rates; the step
counter exactly.  Plus the JAX tests' own convergence cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import sgd as jopt
from repro_torch import convert
from repro_torch.optim import sgd as topt
from repro_torch.utils import trees
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"a": (7,), "b": {"w": (3, 5), "v": {"z": (2, 2, 3)}}, "c": ()}


def _tree(rng, scale=1.0, positive=False):
    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        x = rng.standard_normal(shape) * scale
        return (np.abs(x) if positive else x).astype(np.float32)
    return make(SHAPES)


def _to_jax(t):
    return {k: _to_jax(v) for k, v in t.items()} if isinstance(t, dict) \
        else jnp.asarray(t)


def _to_torch(t):
    return trees.tree_map(torch.tensor, t)


def _close(got, want, what):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _run(jo, to, state_np=None, steps=4, seed=0):
    rng = np.random.default_rng(seed)
    p = _tree(rng)
    pj, pt = _to_jax(p), _to_torch(p)
    if state_np is None:
        sj, st = jo.init(pj), to.init(pt)
    else:
        sj = _to_jax(state_np)
        st = convert.opt_state_from_tree(state_np)
    for i in range(steps):
        g = _tree(rng, 0.3)
        pj, sj = jo.update(_to_jax(g), sj, pj)
        pt, st = to.update(_to_torch(g), st, pt)
        _close(pt, pj, f"params step {i}")
        assert int(st["step"]) == int(sj["step"])
        for k in st:
            if k != "step":
                _close(st[k], sj[k], f"state {k} step {i}")
    assert int(st["step"]) == int(sj["step"])
    assert st["step"].dtype == torch.int32


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                                (0.9, True)])
@pytest.mark.parametrize("sched", ["const", "exp", "cos"])
def test_sgd_matches_jax(momentum, nesterov, sched):
    lrs = {"const": (0.05, 0.05),
           "exp": (jopt.exponential_decay(0.25, 0.99),
                   topt.exponential_decay(0.25, 0.99)),
           "cos": (jopt.cosine_schedule(0.1, 2, 6),
                   topt.cosine_schedule(0.1, 2, 6))}[sched]
    _run(jopt.sgd(lrs[0], momentum, nesterov),
         topt.sgd(lrs[1], momentum, nesterov), steps=6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("mid_run", [False, True])
def test_adamw_matches_jax(weight_decay, mid_run):
    """From a zero state, and from step 37 with random moments (the bias
    correction at a mid-run step)."""
    state = None
    if mid_run:
        rng = np.random.default_rng(11)
        state = {"step": np.int32(37), "m": _tree(rng, 0.1),
                 "v": _tree(rng, 0.01, positive=True)}
    _run(jopt.adamw(3e-4, weight_decay=weight_decay),
         topt.adamw(3e-4, weight_decay=weight_decay), state)


@pytest.mark.parametrize("mid_run", [False, True])
def test_momentum_state_carried_across(mid_run):
    state = None
    if mid_run:
        state = {"step": np.int32(5),
                 "mu": _tree(np.random.default_rng(2), 0.2)}
    _run(jopt.sgd(0.02, momentum=0.9), topt.sgd(0.02, momentum=0.9), state)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_config_builds_the_same(name):
    cfg_j = jopt.OptimizerConfig(name=name, lr=0.01, weight_decay=0.05)
    cfg_t = topt.OptimizerConfig(name=name, lr=0.01, weight_decay=0.05)
    _run(cfg_j.build(), cfg_t.build(), steps=3)
    with pytest.raises(ValueError):
        topt.OptimizerConfig(name="lion").build()


@pytest.mark.parametrize("which", ["exp", "cos"])
def test_schedules_match_jax(which):
    if which == "exp":
        fj, ft = jopt.exponential_decay(0.25, 0.99), \
            topt.exponential_decay(0.25, 0.99)
    else:
        fj, ft = jopt.cosine_schedule(1e-3, 10, 100, floor=1e-5), \
            topt.cosine_schedule(1e-3, 10, 100, floor=1e-5)
    for s in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        want = float(fj(jnp.asarray(s, jnp.int32)))
        got = float(ft(torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


def test_bf16_parameters_keep_their_dtype():
    """The update is float32 and cast back, as in the JAX package."""
    p = {"w": torch.randn(8).to(torch.bfloat16)}
    opt = topt.adamw(1e-2, weight_decay=0.1)
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.float32
    p2, st = opt.update({"w": torch.ones(8, dtype=torch.bfloat16)}, st, p)
    assert p2["w"].dtype == torch.bfloat16


def test_sgd_exponential_decay_steps():
    """The JAX tests' hand-computed SGD schedule."""
    opt = topt.OptimizerConfig(name="sgd", lr=0.1, lr_decay=0.5).build()
    p = {"w": torch.tensor([1.0, 2.0])}
    g = {"w": torch.tensor([1.0, 1.0])}
    st = opt.init(p)
    p1, st = opt.update(g, st, p)
    np.testing.assert_allclose(p1["w"].numpy(), [0.9, 1.9], rtol=1e-6)
    p2, st = opt.update(g, st, p1)
    np.testing.assert_allclose(p2["w"].numpy(), [0.85, 1.85], rtol=1e-6)


def test_adamw_converges_quadratic():
    """tests/test_models.py's case: AdamW at lr 0.1 on w^2 from 5."""
    opt = topt.OptimizerConfig(name="adamw", lr=0.1).build()
    p = {"w": torch.tensor([5.0])}
    st = opt.init(p)
    for _ in range(200):
        p, st = opt.update({"w": 2 * p["w"]}, st, p)
    assert abs(float(p["w"][0])) < 1e-2


def test_momentum_accelerates():
    """Bare tensors as parameters; momentum 0.9 ends closer to 0."""
    ends = []
    for mom in (0.0, 0.9):
        opt = topt.sgd(0.02, momentum=mom)
        p = torch.tensor([4.0])
        st = opt.init(p)
        for _ in range(50):
            p, st = opt.update(2 * p, st, p)
        ends.append(abs(float(p[0])))
    assert ends[1] < ends[0]


def test_tree_helpers_match_jax():
    from repro.utils import trees as jt
    rng = np.random.default_rng(0)
    a, b = _tree(rng), _tree(rng)
    ja, jb_ = _to_jax(a), _to_jax(b)
    ta, tb_ = _to_torch(a), _to_torch(b)
    _close(trees.tree_add(ta, tb_), jt.tree_add(ja, jb_), "add")
    _close(trees.tree_sub(ta, tb_), jt.tree_sub(ja, jb_), "sub")
    _close(trees.tree_scale(ta, 0.3), jt.tree_scale(ja, 0.3), "scale")
    _close(trees.tree_axpy(0.7, ta, tb_), jt.tree_axpy(0.7, ja, jb_), "axpy")
    _close(trees.tree_zeros_like(ta), jt.tree_zeros_like(ja), "zeros")
    _close(trees.tree_weighted_sum([ta, tb_], [0.25, 0.75]),
           jt.tree_weighted_sum([ja, jb_], [0.25, 0.75]), "weighted")
    np.testing.assert_allclose(float(trees.tree_dot(ta, tb_)),
                               float(jt.tree_dot(ja, jb_)), rtol=1e-5)
    np.testing.assert_allclose(float(trees.global_norm(ta)),
                               float(jt.global_norm(ja)), rtol=RTOL)
    assert trees.tree_param_count(ta) == jt.tree_param_count(ja)
    assert trees.tree_bytes(ta) == jt.tree_bytes(ja)
    cast = trees.tree_cast(ta, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in trees.tree_leaves(cast))
