"""The layout arithmetic of two CUDA kernels, checked on the CPU.

FedAvg combine (kernels/csrc/fedavg.cu): the bulk-copy plan that
``kernels/fedavg.copy_plan`` mirrors.  Each row chunk is copied as its
128-byte aligned superset into a shared-memory slot and read at an element
offset; the tests replay the consumers' reads from an emulated memory
(every element of every row read exactly once, from the slot or, at the
tensor's clamped ends, from global memory, and equal to the element) and
check that no copy leaves the tensor, for N = 1..40, N = 0..7 (mod 8), the
paper CNN's N, G in {1, 2}, C in {1, 3, 5, 100}, float32 and bfloat16, and
data pointers off 16-byte alignment.

Bandit round (kernels/csrc/bandit_round.cu): a torch emulation of the
selection step, which maps each value to an order-preserving uint32 key
(``select_key``) and reduces per thread (slots tid * PER + j), per warp
(the max key by ``redux.sync``, then the first lane holding it by a
ballot) and across warps in the same way.  It must select
what the ``better()`` order selects (larger value, then lower slot; NaN
never; an exhausted mask -1) on random values with forced ties, +-0.0,
-inf, NaN and all-invalid rows, and reproduce the plain round's picks for
all 8 policies from the plain gather's estimates.  All exact.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (mid_run_tree, sorted_candidates,  # noqa: E402
                           stack_trees)

from repro_torch.core import bandit  # noqa: E402
from repro_torch.kernels import fedavg  # noqa: E402
from repro_torch.sim.truncnorm import truncnorm_transform  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

CSRC = Path(fedavg.__file__).resolve().parent / "csrc"
N_CNN = 4_583_146
ITEMSIZE = {"float32": 4, "bfloat16": 2}


# ---------------------------------------------------------------------------
# FedAvg: the bulk-copy plan
# ---------------------------------------------------------------------------

def test_plan_constants_match_cuda_source():
    src = (CSRC / "fedavg.cu").read_text()
    assert int(re.search(r"kRowBytes = (\d+);", src).group(1)) == \
        fedavg.ROW_BYTES
    assert re.search(r"kSlotBytes = kRowBytes \+ (\d+);", src).group(1) == \
        str(fedavg.SLOT_BYTES - fedavg.ROW_BYTES)


def _check_plan(p, base, g, c, n, isz):
    """Invariants of a plan that hold whatever its size."""
    end = base + g * c * n * isz
    # the chunks tile the flat tensor in order, each element in one chunk
    assert p["elem"][0] == 0 and p["elem"][-1] + p["len"][-1] == g * c * n
    assert np.array_equal(p["elem"][1:], p["elem"][:-1] + p["len"][:-1])
    assert np.all(p["len"] <= fedavg.ROW_BYTES // isz) and np.all(p["len"] > 0)
    # the offset of the chunk's first element in its 128-byte line
    sb = base + p["elem"] * isz
    assert np.array_equal(p["off"], (sb % 128) // isz)
    # copies: 16-byte aligned, inside the tensor and inside the slot
    cp = p["bytes"] > 0
    for key in ("src", "dst", "bytes"):
        assert np.all(p[key] % 16 == 0), key
    assert np.all(p["bytes"] >= 0)
    assert np.all(p["src"][cp] >= base) and np.all(
        p["src"][cp] + p["bytes"][cp] <= end)
    assert np.all(p["dst"] + p["bytes"] <= fedavg.SLOT_BYTES)
    assert np.all((p["off"] + p["len"]) * isz <= fedavg.SLOT_BYTES)
    # slot elements [lo, hi) lie inside the copied bytes, at the same place
    sl = p["lo"] < p["hi"]
    assert np.all(sb[sl] + p["lo"][sl] * isz >= p["src"][sl])
    assert np.all(sb[sl] + p["hi"][sl] * isz <= p["src"][sl]
                  + p["bytes"][sl])
    assert np.array_equal(p["src"] - p["dst"], sb - p["off"] * isz)
    # global reads only where the tensor's ends are clamped: < 16 bytes
    n_global = np.where(sl, p["lo"] + p["len"] - p["hi"], p["len"])
    head = (-base) % 16 // isz
    tail = (end % 16) // isz
    assert n_global.sum() == min(head + tail, g * c * n)
    return n_global


def _replay(p, base, g, c, n, isz):
    """Run the consumers' reads on an emulated memory whose element k holds
    k; bytes outside the tensor hold a marker that must never be read."""
    end = base + g * c * n * isz
    dt = np.dtype(f"<u{isz}")
    mem = np.full(end + 64, 0xEE, np.uint8)
    mem[base:end] = np.arange(g * c * n, dtype=dt).view(np.uint8)
    reads = np.zeros(g * c * n, np.int64)
    for i in range(len(p["elem"])):
        slot = np.full(fedavg.SLOT_BYTES, 0xCD, np.uint8)
        src, dst, nb = (int(p[k][i]) for k in ("src", "dst", "bytes"))
        if nb:
            slot[dst:dst + nb] = mem[src:src + nb]
        e0, ln, off = int(p["elem"][i]), int(p["len"][i]), int(p["off"][i])
        e = np.arange(ln)
        in_slot = (e >= p["lo"][i]) & (e < p["hi"][i])
        from_slot = slot[(off + e[in_slot])[:, None] * isz
                         + np.arange(isz)].reshape(-1).view(dt)
        g_addr = base + (e0 + e[~in_slot]) * isz
        assert np.all(g_addr >= base) and np.all(g_addr + isz <= end)
        from_global = mem[g_addr[:, None] + np.arange(isz)].reshape(-1).view(dt)
        got = np.empty(ln, np.int64)
        got[in_slot], got[~in_slot] = from_slot, from_global
        np.testing.assert_array_equal(got, (e0 + e) % (1 << 8 * isz))
        reads[e0:e0 + ln] += 1
    assert np.all(reads == 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", list(range(1, 41)))
def test_fedavg_plan_small_rows_read_once(n, dtype):
    isz = ITEMSIZE[dtype]
    for g in (1, 2):
        for c in (1, 3, 5, 100):
            for base in range(4096, 4096 + 16, isz):
                p = fedavg.copy_plan(base, g, c, n, isz)
                _check_plan(p, base, g, c, n, isz)
                if c < 100 or base % 16 in (0, 16 - isz):
                    _replay(p, base, g, c, n, isz)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rem", list(range(8)))
def test_fedavg_plan_rows_by_residue(rem, dtype):
    """N = 0..7 (mod 8) across several tiles: rows start at every offset
    within a 16-byte line."""
    isz = ITEMSIZE[dtype]
    n = 3 * fedavg.ROW_BYTES // isz + 8 + rem
    for g, c in ((1, 3), (2, 5)):
        for base in (8192, 8192 + isz, 8192 + 16 - isz):
            p = fedavg.copy_plan(base, g, c, n, isz)
            _check_plan(p, base, g, c, n, isz)
            _replay(p, base, g, c, n, isz)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,c", [(1, 5), (2, 5), (1, 100), (2, 100)])
def test_fedavg_plan_paper_cnn(g, c, dtype):
    """The main path's N: only the clamped ends go to global memory, and
    every interior chunk is read wholly from its slot."""
    isz = ITEMSIZE[dtype]
    for base in (1 << 21, (1 << 21) + isz):
        p = fedavg.copy_plan(base, g, c, N_CNN, isz)
        n_global = _check_plan(p, base, g, c, N_CNN, isz)
        assert np.all(n_global[1:-1] == 0)
        assert N_CNN % (16 // isz) != 0          # rows really are unaligned
        assert len(np.unique((base + p["elem"] * isz) % 16)) > 1


# ---------------------------------------------------------------------------
# Bandit round: the redux argmax on order-preserving keys
# ---------------------------------------------------------------------------

NONE = 0xFFFFFFFF


def select_key(v: torch.Tensor) -> torch.Tensor:
    """``select_key`` of csrc/bandit_round.cu on float32 values, as int64:
    -0.0 -> +0.0, then the sign-flip image, NaN -> 0."""
    u = (v.float() + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    k = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(v), 0, k)


def block_shape(c: int):
    """``block_shape`` of csrc/bandit_round.cu, and the kernel's selecting
    threads: (threads that select, slots each owns)."""
    threads = min(max(-(-c // 32) * 32, 32), 1024)
    per = 4
    while per * 1024 < c:
        per *= 2
    return min(threads, -(-(-(-c // per)) // 32) * 32), per


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (``__ffs`` of a
    ballot)."""
    return mask.int().argmax(-1)


def kernel_argmax(values: torch.Tensor, avail: torch.Tensor) -> int:
    """One selection step of the kernel on [C] values: thread tid holds
    slots tid * PER + j and keeps its first largest key; a warp takes the
    max key (``__reduce_max_sync``) and its first lane with that key
    (``__ffs`` of a ballot); every warp does the same over the warps'
    winners.  Returns the slot or -1."""
    c = values.shape[0]
    nt, per = block_shape(c)
    key = torch.zeros(nt * per, dtype=torch.int64)
    key[:c] = torch.where(avail, select_key(values), 0)
    key = key.view(nt, per)                       # [tid, j]
    # per thread: strict > over j keeps the lowest j among equal keys
    bj = torch.zeros(nt, dtype=torch.int64)
    bk = torch.zeros(nt, dtype=torch.int64)
    for j in range(per):
        better = key[:, j] > bk
        bk = torch.where(better, key[:, j], bk)
        bj = torch.where(better, j, bj)
    slot = torch.arange(nt) * per + bj
    # per warp: the max key and the first lane holding it
    wk = bk.view(-1, 32).amax(1)
    lane = _first(bk.view(-1, 32) == wk[:, None])
    ws = slot.view(-1, 32).gather(1, lane[:, None])[:, 0]
    # across warps, by every warp after the step's barrier
    mk = wk.amax()
    return -1 if mk == 0 else int(ws[_first(wk == mk)])


def better_argmax(values, avail) -> int:
    """The argmax the first kernel defined by better(): a fold from
    (-inf, none) keeping (v, i) when v > bv or (v == bv and i < bi)."""
    bv, bi = -math.inf, None
    for i, (v, ok) in enumerate(zip(values.tolist(), avail.tolist())):
        if ok and (v > bv or (v == bv and (bi is None or i < bi))):
            bv, bi = v, i
    return -1 if bi is None else bi


def _values(rng, c, kind):
    v = rng.standard_normal(c).astype(np.float32)
    if kind == "ties":
        v = np.round(v * 2) / 2                   # many exact ties
    elif kind == "zeros":
        v[rng.random(c) < 0.5] = 0.0
        v[rng.random(c) < 0.5] = -0.0
        v[rng.random(c) < 0.2] = -1.0
    elif kind == "specials":
        pick = rng.random(c)
        v[pick < 0.3] = -np.inf
        v[(pick >= 0.3) & (pick < 0.5)] = np.nan
        v[(pick >= 0.5) & (pick < 0.55)] = np.inf
    elif kind == "neg_inf_nan":
        v[:] = -np.inf
        v[rng.random(c) < 0.5] = np.nan
    return torch.from_numpy(v)


def test_select_key_orders_like_floats():
    vals = torch.tensor([-math.inf, -3e38, -1.0, -1e-40, -0.0, 0.0, 1e-40,
                         1.0, 3e38, math.inf], dtype=torch.float32)
    keys = select_key(vals).tolist()
    assert keys[0] > 0                             # -inf above "none"
    assert keys[4] == keys[5]                      # -0.0 ties +0.0
    assert keys == sorted(keys) and len(set(keys)) == len(keys) - 1
    assert select_key(torch.tensor([math.nan, -math.nan])).tolist() == [0, 0]


@pytest.mark.parametrize("kind", ["plain", "ties", "zeros", "specials",
                                  "neg_inf_nan"])
@pytest.mark.parametrize("c", [1, 10, 31, 33, 100, 255, 256, 257, 1000,
                               1025, 4097])
def test_redux_argmax_selects_what_better_selects(c, kind):
    rng = np.random.default_rng(c + len(kind))
    for trial in range(3):
        v = _values(rng, c, kind)
        avail = torch.from_numpy(rng.random(c) < (0.7, 0.3, 0.0)[trial])
        for _ in range(min(c, 6) + 1):             # S steps, then exhausted
            want = better_argmax(v, avail)
            assert kernel_argmax(v, avail) == want
            if want < 0:
                break
            avail[want] = False


def _gathered(policy, state, cand, t_ud, t_ul, rand):
    """The plain round's per-candidate estimates (ref.bandit_round_ref up
    to the selection) on candidate-aligned times."""
    k = state.n_sel.shape[1]
    cvalid = cand < k
    safe = torch.where(cvalid, cand, 0).long()

    def col(name):
        if name.startswith("hist_sum_"):
            h = getattr(state, "hist_" + name[len("hist_sum_"):])
            return bandit.row_sum(
                h.gather(1, safe[..., None].expand(-1, -1, h.shape[2])))
        return getattr(state, name).gather(1, safe)

    obs = {name: col(name) for name in bandit.POLICY_STATS[policy]}
    rand_c = None if rand is None else rand.gather(1, safe)
    kind, a, b = bandit.policy_scores(
        policy, obs, state.total, state.disc_total, t_ud, t_ul, rand_c,
        bandit.DEFAULT_HYPERS[policy])
    return kind, a, b, cvalid


def kernel_select(kind, a, b, valid, s_round):
    """The kernel's S steps on [G, C] estimates: the emulated argmax on
    the score or on -T_inc from each grid point's running clock."""
    out = torch.full((a.shape[0], s_round), -1, dtype=torch.int32)
    for g in range(a.shape[0]):
        avail = valid[g].clone()
        t = torch.zeros((), dtype=torch.float32)
        td = torch.zeros((), dtype=torch.float32)
        for i in range(s_round):
            if kind == "score":
                v = a[g]
            else:
                ntd = torch.maximum(td, b[g])
                v = -((ntd - td) + torch.clamp_min(a[g] - (t - td), 0.0)
                      + b[g])
            p = kernel_argmax(v, avail)
            out[g, i] = p
            if p < 0:
                continue
            avail[p] = False
            if kind != "score":
                ud, ul = a[g, p], b[g, p]
                inc = (torch.maximum(td, ul) - td) + torch.clamp_min(
                    ud - (t - td), 0.0) + ul
                t, td = torch.clamp_min(t + inc, 0.0), torch.maximum(td, ul)
    return out


@pytest.mark.parametrize("c", [40, 257])
@pytest.mark.parametrize("policy", bandit.POLICY_NAMES)
def test_emulated_kernel_select_matches_plain_round(policy, c):
    g, k, s_round = 3, 600, 12
    rng = np.random.default_rng(len(policy) + c)
    state = bandit.state_from_tree(stack_trees(
        [mid_run_tree(rng, k) for _ in range(g)]))
    cand = torch.from_numpy(sorted_candidates(rng, g, k, c, n_valid=c - 3))
    safe = torch.where(cand < k, cand, 0).long()
    # Eq. (8) times at the candidates, with some exact ties
    theta = torch.from_numpy(rng.uniform(2e5, 8e6, (g, k)).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(10, 100, (g, k)).astype(np.float32))
    u2 = torch.from_numpy(rng.random((g, 2, c), np.float32))
    drawn = truncnorm_transform(
        u2, torch.stack([theta.gather(1, safe), gamma.gather(1, safe)], 1),
        1.5)
    t_ud = torch.round(500.0 / drawn[:, 1])
    t_ul = bandit.fdiv(146.4e6, drawn[:, 0])
    rand = (torch.from_numpy(rng.random((g, k), np.float32))
            if policy == "random" else None)
    kind, a, b, valid = _gathered(policy, state, cand, t_ud, t_ul, rand)
    if kind == "score":
        want = bandit.top_slots(a, valid, s_round)
    else:
        want = bandit.greedy_slots(a, b, valid, s_round)
    got = kernel_select(kind, a, b, valid, s_round)
    assert torch.equal(got, want)
