"""The float32 attention kernel's arithmetic (kernels/csrc/flash_attention.cu,
3xTF32 on the tensor cores) emulated in plain torch on the CPU, and the
wrapper's tile plan against the CUDA source.

The kernel runs only on the card.  Here its arithmetic is rebuilt step by
step: tf32 round-to-nearest (ties away, ``cvt.rna``) by int32 bit
operations, every operand as hi = tf32(x) plus lo = tf32(x - hi), every
product as lo.hi + hi.lo + hi.hi (the small terms first, lo.lo dropped,
float32 sums), the logits times dh**-0.5 in float32, masked logits -1e30,
``exp`` once per logit, the online softmax over the kernel's key tiles, and
P fed to the P.V product through the register fragment maps with V's keys
permuted as the split pass stores them.  It is held against the plain
version (``kernels/ref.flash_attention_ref``) under chip_smoke.py's float32
gate, rtol 2e-5 / atol 1e-5: the JAX package's tolerance for its kernel.
One TF32 product (hi only) leaves that gate, which is why the kernel does
three.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "flash_attention.cu")
F32_GATE = dict(rtol=2e-5, atol=1e-5)


def _inputs(seed, b, sq, skv, kv, g, dh):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in ((b, sq, kv, g, dh), (b, skv, kv, dh), (b, skv, kv, dh))]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 to 10 mantissa bits, to nearest, ties
    away from zero (add half of the dropped unit to the magnitude, then
    clear the 13 dropped bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b as the kernel's TF32 products: lo.hi, hi.lo, then hi.hi into
    one float32 sum (``terms=1``: hi.hi alone, one TF32 product)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if terms == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def split_key(c: int) -> int:
    """The split pass's V^T row order (csrc/flash_attention.cu,
    kv_split_tf32_kernel): the key stored at position c."""
    return (c & ~7) | (2 * (c & 3) + 1 if c & 4 else 2 * (c & 3))


# register fragment maps of one warp's 16 rows and one 8-key group, as the
# PTX ISA gives them for wgmma (per warp as mma.m16n8k8): the float32
# accumulator's value e of thread (grp, tq) is row grp + 8 (e // 2), column
# 2 tq + e % 2; the tf32 A fragment's register r is row grp + 8 (r % 2),
# k index tq + 4 (r // 2); split_p feeds register r from S value
# (0, 2, 1, 3)[r]
def acc_cell(grp, tq, e):
    return grp + 8 * (e // 2), 2 * tq + e % 2


def a_cell(grp, tq, r):
    return grp + 8 * (r % 2), tq + 4 * (r // 2)


SPLIT_P = (0, 2, 1, 3)


def a_operand(p: torch.Tensor) -> torch.Tensor:
    """The A operand [..., 16 rows, BN k] that the P.V product sees when P's
    accumulator fragments feed it through SPLIT_P: a gather of ``p``
    [..., 16, BN] by the fragment maps, one 8-key group at a time."""
    bn = p.shape[-1]
    src = torch.empty(16 * bn, dtype=torch.long)
    for k0 in range(0, bn, 8):
        for grp in range(8):
            for tq in range(4):
                for r in range(4):
                    row, col = acc_cell(grp, tq, SPLIT_P[r])
                    arow, ak = a_cell(grp, tq, r)
                    src[arow * bn + k0 + ak] = row * bn + k0 + col
    flat = p.reshape(*p.shape[:-2], 16 * bn)
    return flat[..., src].reshape(p.shape)


def emulate_kernel(q, k, v, causal, dh_tile=None, terms=3):
    """The float32 kernel's arithmetic over its key tiles (F32_TILES's BN
    for dh, or ``dh_tile``), per (b, kv head) on its (position, q head)
    rows: S in three TF32 products, the scale, masks, exp and the online
    softmax in float32, P.V with P through the A-fragment maps in 16-row
    groups and V's rows in the split pass's order, output
    acc / max(l, 1e-30)."""
    b, sq, kv, g, dh = q.shape
    skv = k.shape[1]
    bn = dh_tile or tflash.F32_TILES[dh][1]
    pad = tflash.f32_key_pad(skv)
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32)
    rows = sq * g
    rpad = -(-rows // 16) * 16
    qf = torch.zeros(b, kv, rpad, dh)
    qf[:, :, :rows] = q.permute(0, 2, 1, 3, 4).reshape(b, kv, rows, dh)
    kf = torch.zeros(b, kv, pad, dh)
    kf[:, :, :skv] = k.permute(0, 2, 1, 3)
    vf = torch.zeros(b, kv, pad, dh)
    vf[:, :, :skv] = v.permute(0, 2, 1, 3)
    perm = torch.tensor([split_key(c) for c in range(pad)])
    vt = vf[:, :, perm]                 # V^T's rows (keys) as stored
    pos = torch.arange(rpad) // g
    m = torch.full((b, kv, rpad), ref.NEG_LOGIT)
    l = torch.zeros(b, kv, rpad)
    acc = torch.zeros(b, kv, rpad, dh)
    n_tiles = -(-(min(skv, sq) if causal else skv) // bn)
    for t in range(n_tiles):
        keys = torch.arange(t * bn, (t + 1) * bn)
        x = mm3(qf, kf[:, :, keys].transpose(-1, -2), terms) * scale
        ok = (keys[None, :] < skv) & (
            keys[None, :] <= pos[:, None] if causal else True)
        x = torch.where(ok, x, ref.NEG_LOGIT)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        pa = a_operand(p.reshape(b, kv, rpad // 16, 16, bn)).reshape(p.shape)
        acc = acc * corr[..., None] + mm3(pa, vt[:, :, keys], terms)
        m = m_new
    o = acc[:, :, :rows] / l[:, :, :rows].clamp_min(1e-30)[..., None]
    return o.reshape(b, kv, sq, g, dh).permute(0, 2, 1, 3, 4)


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # a tf32 value
    for x, want in [(1.0 + 2.0 ** -11, one),     # a tie: away from zero
                    (-(1.0 + 2.0 ** -11), -one),
                    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),
                    (1.0 + 2.0 ** -12, 1.0), (3.0, 3.0), (0.0, 0.0)]:
        got = tf32(torch.tensor([x], dtype=torch.float32))
        assert got.item() == want, (x, got.item(), want)
    x = torch.tensor(np.random.default_rng(0).standard_normal(10_000),
                     dtype=torch.float32)
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())
    # hi + lo carries x to ~22 bits
    assert bool(((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all())


def test_split_pass_key_order_is_the_fragment_maps():
    """P feeds the P.V product unchanged when V's rows follow the split
    pass's order: A's k index kk holds S's key split_key(kk), and the sum
    over keys is the same."""
    for grp in range(8):
        for tq in range(4):
            for r in range(4):
                row, col = acc_cell(grp, tq, SPLIT_P[r])
                arow, ak = a_cell(grp, tq, r)
                assert row == arow and col == split_key(ak)
    assert sorted(split_key(c) for c in range(64)) == list(range(64))
    rng = np.random.default_rng(1)
    p = torch.tensor(rng.standard_normal((2, 16, 64)), dtype=torch.float64)
    v = torch.tensor(rng.standard_normal((64, 32)), dtype=torch.float64)
    perm = [split_key(c) for c in range(64)]
    torch.testing.assert_close(a_operand(p) @ v[perm], p @ v, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("b,sq,skv,kv,g,dh,causal", [
    (1, 1024, 1024, 1, 3, 64, True), (1, 1024, 1024, 1, 3, 64, False),
    (1, 300, 300, 2, 2, 32, True), (1, 330, 270, 2, 3, 32, False),
    (2, 333, 333, 1, 3, 128, True), (1, 270, 350, 2, 2, 128, False),
    (2, 200, 130, 1, 4, 64, True)],
    ids=["dh64-causal", "dh64-full", "dh32-causal", "dh32-ragged-full",
         "dh128-ragged-causal", "dh128-ragged-full", "dh64-sq-gt-skv"])
def test_3xtf32_arithmetic_within_the_f32_gate(b, sq, skv, kv, g, dh,
                                               causal):
    q, k, v = _inputs(sq + skv + dh, b, sq, skv, kv, g, dh)
    got = emulate_kernel(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal)
    torch.testing.assert_close(got, want, **F32_GATE)


def test_one_tf32_product_leaves_the_f32_gate():
    """Why three products: with one TF32 product (hi.hi) most outputs leave
    the float32 gate."""
    q, k, v = _inputs(4, 1, 1024, 1024, 1, 3, 64)
    got = emulate_kernel(q, k, v, True, terms=1)
    want = ref.flash_attention_ref(q, k, v, True)
    bad = ~torch.isclose(got, want, **F32_GATE)
    assert int(bad.sum()) > want.numel() // 4


def f32_smem(dh: int) -> int:
    """Dynamic shared memory of a float32 kernel block (``Tile<DH>::SMEM``
    in the .cu): Q_hi and Q_lo, the ring of K_hi, K_lo, V_hi^T, V_lo^T
    tiles, 4 mbarriers a stage, 1024 bytes of alignment slack."""
    _, bn, stages = tflash.F32_TILES[dh]
    return 1024 + 2 * tflash.f32_rows(dh) * dh * 4 + stages * (
        4 * bn * dh * 4 + 4 * 8)


def _cu_const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_tile_plan_matches_cuda_source():
    src = CSRC.read_text()
    shapes = {int(dh): tuple(int(x) for x in rest) for dh, *rest in
              re.findall(r"struct Shape<(\d+)> \{ static constexpr int "
                         r"CONSUMERS = (\d+), BN = (\d+), STAGES = (\d+); \}",
                         src)}
    assert shapes == tflash.F32_TILES
    assert _cu_const(src, "kKeyPad") == tflash.F32_KEY_PAD
    assert _cu_const(src, "kSplitKeys") == tflash.F32_SPLIT_KEYS


@pytest.mark.parametrize("dh", tflash.HEAD_DIMS)
def test_tile_plan_fits_the_card(dh):
    """Each head width's plan keeps to a block's shared memory and, with
    32 registers a thread to spare, to the launch's registers (ptxas sizes
    them by warpgroups: two consumers and the producer warp get 168): S
    (BN / 2) as it turns into P's hi and lo (BN), and O (dh / 2); every
    tile is whole in the padded keys and a tf32 k-step (8 keys) never
    crosses a 128-byte panel."""
    consumers, bn, stages = tflash.F32_TILES[dh]
    assert f32_smem(dh) <= 232448         # a block's, on an H100
    warpgroups = consumers + 1            # the producer warp rounds up
    regs = min(255, 65536 // (128 * warpgroups) // 8 * 8)
    assert bn // 2 + bn + dh // 2 + 32 <= regs
    assert stages >= 2                    # a tile loads while one is used
    assert tflash.F32_KEY_PAD % bn == 0 and bn % 32 == 0 and dh % 32 == 0
    assert tflash.F32_KEY_PAD % tflash.F32_SPLIT_KEYS == 0


@pytest.mark.parametrize("b,skv,kv,dh,want", [
    (4, 4096, 3, 64, (4, 12, 4096 * 64)), (2, 1000, 1, 128, (4, 2, 1024 * 128)),
    (1, 1, 2, 32, (4, 2, 64 * 32)), (1, 64, 1, 32, (4, 1, 64 * 32)),
    (1, 65, 1, 32, (4, 1, 128 * 32))])
def test_f32_scratch_shape(b, skv, kv, dh, want):
    assert tflash.f32_scratch_shape(b, skv, kv, dh) == want
    # row strides of the split arrays are whole 16-byte units (TMA)
    assert tflash.f32_key_pad(skv) * 4 % 16 == 0


def test_f32_wrapper_refuses_cpu_tensors():
    q, k, v = _inputs(0, 1, 16, 16, 1, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_cuda(q, k, v)
