"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
LLaMA-arch GQA [arXiv:2403.04652; hf].

A copy of ``repro.configs.yi_9b`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
)

REDUCED = LMConfig(
    name="yi-9b-reduced", family="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, remat=False,
)
