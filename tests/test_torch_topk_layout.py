"""The local top-S kernel's split-and-merge arithmetic, checked on the CPU.

kernels/csrc/topk_slots.cu splits each row of C entries over a cluster of
B blocks (as ``kernels/topk_slots.plan`` decides for the launch), stages
each chunk's entries as order-preserving uint32 keys (0 outside L: invalid
or -inf; NaN above every number), keeps a tournament tree of first maxima
(one per thread's group of entries j = tid + n * T, one per 32 groups) and
runs S steps: the cluster's best is the largest key, then the lowest index;
the pick's key becomes 0 (or its bit is set, where the chunk streams past
its staged keys) and its group is rescanned.  Once L is spent, entry 0
gives (-inf, 0) once if it is valid with score -inf, then (-inf, -1).

``emulate`` replays that selection with explicit chunks, groups, tree
nodes and warp reductions, and must equal ``kernels/ref.local_topk_ref``
bitwise (values compared as bits, so NaN and -0.0 count) on C = 1..70 with
B = 1..16, S from 1 to past C, streamed chunks, ties, NaN, valid -inf, a
live -inf at index 0, all-invalid rows and the segmented round's masking;
for a subset also the JAX package's ``local_topk_ref``.  The limits the
plan keeps to are read from the CUDA source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import topk_slots  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

CSRC = Path(topk_slots.__file__).resolve().parent / "csrc" / "topk_slots.cu"
NONE = (0, 0xFFFFFFFF)
JAX_LOCAL_TOPK = jax.jit(jref.local_topk_ref, static_argnums=2)


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def keys_of(score: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """``key_of`` of the kernel, as int64: 0 outside L, 0xffffffff for NaN,
    else the float's bits mapped to an order-preserving uint32."""
    s = np.where(score == 0, np.float32(0), score).astype(np.float32)
    bits = s.view(np.uint32).astype(np.int64)
    k = np.where(bits >= 1 << 31, 0xFFFFFFFF - bits, bits | 1 << 31)
    k = np.where(np.isnan(score), 0xFFFFFFFF, k)
    return np.where(valid & (score != -np.inf), k, 0)


def warp_best(bests):
    """Two redux.sync: the largest key, then the lowest index holding it."""
    k = max(bests)[0]
    return k, min(i for kk, i in bests if kk == k)


class Block:
    """One block's chunk [c0, c0 + n) of a row: staged keys, the streamed
    entries' pick bitmap and the tournament tree.  ``row_keys`` are the
    row's keys as the staging loads compute them (a streamed entry's key is
    recomputed from global memory at each rescan: the same number)."""

    def __init__(self, row_keys, c0, n, staged, threads):
        self.c0, self.n, self.t = c0, max(n, 0), threads
        self.staged = min(staged, self.n)
        self.row_keys = row_keys
        self.keys = row_keys[c0:c0 + self.staged]     # a copy: shared memory
        self.picked = [False] * (self.n - self.staged)
        # staging: each thread's first maximum over its entries in order
        self.group = [self._scan(range(g, self.n, threads)) if g < self.n
                      else NONE for g in range(threads)]
        self.node = [warp_best(self.group[w:w + 32])
                     for w in range(0, threads, 32)]

    def _key(self, e):
        if e < self.staged:
            return self.keys[e]
        return 0 if self.picked[e - self.staged] else self.row_keys[
            self.c0 + e]

    def _scan(self, entries):
        best = NONE
        for e in entries:
            k = self._key(e)
            if k > best[0]:
                best = (k, self.c0 + e)
        return best

    def best(self):
        return warp_best(self.node)

    def take(self, idx):
        """Mark the pick and refresh its group's two tree nodes: lane m
        rescans entries g + (m + 32 i) * T, then one warp reduction."""
        e = idx - self.c0
        if e < self.staged:
            self.keys[e] = 0
        else:
            self.picked[e - self.staged] = True
        g = e % self.t
        lanes = [self._scan(range(g + m * self.t, self.n, 32 * self.t))
                 for m in range(32)]
        self.group[g] = warp_best(lanes)
        w = g // 32
        self.node[w] = warp_best(self.group[32 * w:32 * w + 32])


def emulate(score, valid, s_round, cluster=None, threads=None, staged=None):
    """The kernel's selection on [R, C] numpy ``score``/``valid``: B =
    ``cluster`` blocks a row (``plan``'s by default), ``threads`` groups a
    block, ``staged`` keys a block (the rest stream; ``plan``'s by
    default)."""
    r, c = score.shape
    p = topk_slots.plan(r, c)
    b = cluster or p.cluster
    chunk = -(-c // b)
    if threads:
        t = threads
    elif cluster is None:
        t = p.threads
    else:                               # plan's rule before any grid cap
        t = topk_slots.MIN_THREADS
        while t < topk_slots.MAX_THREADS and t * topk_slots.PER_THREAD < chunk:
            t *= 2
    if staged is None:
        staged = p.staged if cluster is None else chunk
    keys = keys_of(score, valid).tolist()
    vals = np.full((r, s_round), -np.inf, np.float32)
    slots = np.full((r, s_round), -1, np.int32)
    for row in range(r):
        blocks = [Block(keys[row], k * chunk, min(chunk, c - k * chunk),
                        staged, t) for k in range(b)]
        i = 0
        while i < s_round:
            key, idx = warp_best([blk.best() for blk in blocks])
            if key == 0:
                break
            vals[row, i], slots[row, i] = score[row, idx], idx
            blocks[idx // chunk].take(idx)
            i += 1
        if i < s_round and valid[row, 0] and score[row, 0] == -np.inf:
            slots[row, i] = 0
    return vals, slots


def assert_bitwise(got, want, where=""):
    gv, gs = (np.asarray(x) for x in got)
    wv, ws = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gs, ws, f"slots {where}")
    np.testing.assert_array_equal(gv.view(np.int32), wv.view(np.int32),
                                  f"value bits {where}")


def plain(score, valid, s_round):
    v, s = ref.local_topk_ref(torch.from_numpy(score),
                              torch.from_numpy(valid), s_round)
    return v.numpy(), s.numpy()


def edge_rows(c, rng):
    """Rows of one length C, one per case: ties (with -0.0 beside 0.0),
    NaN, valid -inf, a live -inf at index 0 with few live entries, all
    invalid, every live score -inf, and the segmented round's masking
    (each entry live in one of three shards, -inf elsewhere)."""
    pool = np.float32([-1.5, -0.0, 0.0, 0.25, 3.0])
    score = rng.choice(pool, size=(9, c)).astype(np.float32)
    valid = rng.random((9, c)) < 0.7
    score[1, rng.random(c) < 0.3] = np.nan
    score[2, rng.random(c) < 0.4] = -np.inf
    score[3, 0], valid[3, 0] = -np.inf, True
    valid[3, 1:] &= rng.random(c - 1) < 0.2
    valid[4] = False
    score[5] = -np.inf
    valid[5, 0] = True
    owner = rng.integers(0, 3, size=c)
    for sh in range(3):
        valid[6 + sh] = owner == sh
        score[6 + sh] = np.where(valid[6 + sh], rng.random(c), -np.inf)
    return score.astype(np.float32), valid


# ---------------------------------------------------------------------------
# the plan against the CUDA source
# ---------------------------------------------------------------------------

def test_plan_constants_match_cuda_source():
    src = CSRC.read_text()

    def const(name):
        return int(eval(re.search(rf"constexpr int {name} = ([\d\s\-+*]+);",
                                  src).group(1)))
    assert const("kMaxThreads") == topk_slots.MAX_THREADS
    assert const("kMaxCluster") == topk_slots.MAX_CLUSTER
    assert const("kSmemBudget") == topk_slots.SMEM_BUDGET
    # the static tree nodes fit beside the budget in a block's 227 KB
    static = 8 * (topk_slots.MAX_THREADS + 32 + 2 * topk_slots.MAX_CLUSTER + 2)
    assert topk_slots.SMEM_BUDGET + static <= 232448


@pytest.mark.parametrize("rows,c,want", [
    (32, 1_000, (1, 1_000, 1_000, 0, 128, 4_000)),      # phase 10, K=10^4
    (16, 100_000, (16, 6_250, 6_250, 0, 256, 25_000)),  # phase 10, K=10^6
    (8, 100_000, (16, 6_250, 6_250, 0, 512, 25_000)),
    (8, 100_001, (16, 6_251, 6_251, 0, 512, 25_004)),
    (32, 100_000, (8, 12_500, 12_500, 0, 256, 50_000)),
    (4, 4_096, (1, 4_096, 4_096, 0, 256, 16_384)),
    (1, 1_000_000, (16, 62_500, 53_854, 1_954, 1024, 223_232)),  # streams
    (1_000, 100_000, (2, 50_000, 50_000, 0, 1024, 200_000)),
    (1, 8_191, (1, 8_191, 8_191, 0, 512, 32_764)),
    (1, 8_192, (2, 4_096, 4_096, 0, 256, 16_384)),
    (1, 1_851_392, (16, 115_712, 52_192, 3_616, 1024, 223_232)),
    (1, 28_573_696, (16, 1_785_856, 0, 55_808, 1024, 223_232)),  # MAX_C
])
def test_plan(rows, c, want):
    assert tuple(topk_slots.plan(rows, c)) == want


def test_plan_takes_every_row_length_up_to_max_c():
    # the PR 13 kernel's longest row (its pick bitmap in one block) and past
    for rows in (1, 16, 4096):
        for c in (1_851_392, 5_000_000, topk_slots.MAX_C):
            p = topk_slots.plan(rows, c)
            assert p.staged >= 0 and p.cluster <= topk_slots.MAX_CLUSTER
            assert p.smem <= topk_slots.SMEM_BUDGET
            assert p.cluster * p.chunk >= c > (p.cluster - 1) * p.chunk
    assert topk_slots.plan(1, topk_slots.MAX_C + 1).staged < 0


@pytest.mark.parametrize("c", [1, 2, 100, 4_096, 8_192, 70_000, 100_001,
                               1_000_000, 20_000_000])
@pytest.mark.parametrize("rows", [1, 4, 16, 32, 1_000])
def test_plan_invariants(rows, c):
    p = topk_slots.plan(rows, c)
    assert 1 <= p.cluster <= min(topk_slots.MAX_CLUSTER,
                                 max(1, c // topk_slots.MIN_CHUNK))
    assert (p.cluster - 1) * p.chunk < c <= p.cluster * p.chunk
    assert p.threads & (p.threads - 1) == 0
    assert topk_slots.MIN_THREADS <= p.threads <= topk_slots.MAX_THREADS
    split = p.cluster > 1 and rows * p.cluster <= topk_slots.TARGET_BLOCKS
    if split and p.threads > topk_slots.MIN_THREADS:
        assert rows * p.cluster * p.threads <= topk_slots.MAX_GRID_THREADS
    if not split:
        assert (p.threads * topk_slots.PER_THREAD >= p.chunk
                or p.threads == topk_slots.MAX_THREADS)
    assert 0 <= p.staged <= p.chunk and p.smem <= topk_slots.SMEM_BUDGET
    if p.staged < p.chunk:      # a streamed tail: its picks in the bitmap
        assert 32 * p.words >= p.chunk - p.staged
        assert 4 * p.chunk > topk_slots.SMEM_BUDGET
    if c <= 8_191:
        assert p.cluster == 1


# ---------------------------------------------------------------------------
# the emulation against the plain version
# ---------------------------------------------------------------------------

def test_keys_order_like_the_argmax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.float32([np.inf, -np.inf, 0.0, -0.0, np.nan, 1e-45, -1e-45,
                    3.4e38, -3.4e38]),
        rng.standard_normal(200).astype(np.float32) * 1e3]).astype(np.float32)
    k = keys_of(x, np.ones_like(x, bool))
    for a in range(len(x)):
        for b in range(len(x)):
            if np.isnan(x[a]) or np.isnan(x[b]):
                assert (k[a] == k[b]) == (np.isnan(x[a]) and np.isnan(x[b]))
                assert (k[a] > k[b]) == (np.isnan(x[a]) and not np.isnan(x[b]))
            elif x[b] == -np.inf:
                assert k[b] == 0 and k[a] >= 0
            else:
                assert (k[a] > k[b]) == (x[a] > x[b])
                assert (k[a] == k[b]) == (x[a] == x[b])
    assert keys_of(x, np.zeros_like(x, bool)).max() == 0


@pytest.mark.parametrize("c", range(1, 71))
def test_split_selection_matches_plain(c):
    """Every B = 1..16 (chunks with no live entry among them) and S = 1,
    2, 5, C and C + 3; by turns the plan's threads with the chunk staged
    whole, 32 threads with half of it streamed, 64 with all of it."""
    rng = np.random.default_rng(c)
    score, valid = edge_rows(c, rng)
    for s_round in sorted({1, 2, 5, c, c + 3}):
        want = plain(score, valid, s_round)
        for b in range(1, 17):
            chunk = -(-c // b)
            t, st = ((None, None), (32, chunk // 2), (64, 0))[b % 3]
            got = emulate(score, valid, s_round, cluster=b, threads=t,
                          staged=st)
            assert_bitwise(got, want, f"B={b} S={s_round} T={t} "
                                      f"staged={st}")


@pytest.mark.parametrize("c,s_round", [(1, 3), (7, 9), (37, 5), (64, 64),
                                       (70, 73)])
def test_split_selection_matches_jax(c, s_round):
    score, valid = edge_rows(c, np.random.default_rng(100 + c))
    for b in (1, 3, 16):
        got = emulate(score, valid, s_round, cluster=b)
        for row in range(score.shape[0]):
            jv, js = JAX_LOCAL_TOPK(jnp.asarray(score[row]),
                                    jnp.asarray(valid[row]), s_round)
            assert_bitwise((got[0][row], got[1][row]), (jv, js),
                           f"row {row} B={b}")


@pytest.mark.parametrize("g,p,c,s_round,streamed", [
    (8, 4, 1_000, 5, 0),            # phase 10 at K=10^4
    (1, 8, 100_001, 5, 0),          # ragged at every chunk boundary
    (2, 2, 4_096, 64, 0),           # the step-count stress
    (1, 2, 100_000, 64, 0),
    (1, 1, 1_000_000, 5, 8_646),    # the chunk outgrows shared memory
])
def test_plan_selection_matches_plain(g, p, c, s_round, streamed):
    """The kernel's own plan at phase 9's shapes, on the segmented round's
    masked scores with ties."""
    rng = np.random.default_rng(c + s_round)
    score = (np.floor(rng.random((g, p, c)) * 64) / 64).astype(np.float32)
    owner = rng.integers(0, p, size=(g, 1, c))
    valid = owner == np.arange(p).reshape(1, p, 1)
    score = np.where(valid, score, -np.inf).astype(np.float32)
    score, valid = score.reshape(g * p, c), valid.reshape(g * p, c)
    pl = topk_slots.plan(g * p, c)
    assert pl.chunk - pl.staged == streamed
    assert_bitwise(emulate(score, valid, s_round),
                   plain(score, valid, s_round), f"plan {pl}")


# ---------------------------------------------------------------------------
# the wrapper's own checks (no card needed)
# ---------------------------------------------------------------------------

def test_wrapper_refuses_cpu_tensors():
    score = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk_slots.local_topk_cuda(score, score > 0, 3)
