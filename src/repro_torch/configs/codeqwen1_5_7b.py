"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (GQA kv=32 == MHA)
d_ff=13440 vocab=92416 — qwen1.5-arch [hf:Qwen/CodeQwen1.5-7B; hf].

A copy of ``repro.configs.codeqwen1_5_7b`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab=92416,
)

REDUCED = LMConfig(
    name="codeqwen1.5-7b-reduced", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, remat=False,
)
