"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

A copy of ``repro.configs.qwen3_1_7b`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, qk_norm=True, tie_embeddings=True,
    d_head=128,
)

REDUCED = LMConfig(
    name="qwen3-1.7b-reduced", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, qk_norm=True, tie_embeddings=True, d_head=32,
    remat=False,
)
