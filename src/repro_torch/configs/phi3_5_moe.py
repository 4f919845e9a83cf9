"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf].

A copy of ``repro.configs.phi3_5_moe`` (the port imports nothing of the JAX
package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig, MoEConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
)

REDUCED = LMConfig(
    name="phi3.5-moe-reduced", family="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256),
    remat=False,
)
