"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared, per the K2 report)
[arXiv:2501.kimi2; unverified].  ~1.03T total params, ~32B active.

A copy of ``repro.configs.kimi_k2`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840,
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
)

REDUCED = LMConfig(
    name="kimi-k2-reduced", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128, n_shared=1),
    remat=False,
)
