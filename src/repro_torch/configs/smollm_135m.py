"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].

A copy of ``repro.configs.smollm_135m`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

CONFIG = LMConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab=49152, tie_embeddings=True,
)

REDUCED = LMConfig(
    name="smollm-135m-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
    d_ff=128, vocab=512, tie_embeddings=True, remat=False,
)
