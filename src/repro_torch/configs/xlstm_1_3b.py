"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517; unverified].

48 layers = 6 groups of (7 mLSTM + 1 sLSTM), the paper's 7:1 ratio.
d_ff=0: no standalone FFN blocks (mLSTM blocks carry a x2 up-projection;
the sLSTM block carries its own 4/3 gated FFN).

A copy of ``repro.configs.xlstm_1_3b`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, mlstm_chunk=256,
)

REDUCED = LMConfig(
    name="xlstm-1.3b-reduced", family="xlstm",
    n_layers=8, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab=512, remat=False,
)
