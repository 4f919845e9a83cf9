"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2 [arXiv:2402.19427; unverified].

38 layers = 12 x (rec, rec, local-attn) + 2 recurrent tail layers.  Local
attention window 2048 (the Griffin paper's setting).

A copy of ``repro.configs.recurrentgemma_9b`` (the port imports nothing of
the JAX package); tests/test_torch_griffin.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="recurrentgemma-9b", family="griffin",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, sliding_window=2048, lru_width=4096,
    d_head=256,
)

REDUCED = LMConfig(
    name="recurrentgemma-9b-reduced", family="griffin",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=1,
    d_ff=256, vocab=512, sliding_window=32, lru_width=128, d_head=32,
    remat=False,
)
