"""seamless-m4t-medium [audio]: 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone only: 12 encoder + 12 decoder layers; the speech frontend is a
STUB (the batch carries precomputed frame embeddings [B, S_enc, d_model]).

A copy of ``repro.configs.seamless_m4t_medium`` (the port imports nothing
of the JAX package); tests/test_torch_lm.py holds the fields equal."""

from repro_torch.models.layers import LMConfig

ENC_STUB_LEN = 4096        # encoder length for decode shapes

CONFIG = LMConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
)

REDUCED = LMConfig(
    name="seamless-m4t-reduced", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, remat=False,
)
