"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling [hf:llava-hf/llava-v1.6; unverified].

Backbone only: the vision tower is a STUB — the batch carries precomputed
patch embeddings [B, 2880, 1024] (anyres 5 tiles x 576 patches, CLIP-L
width 1024); a learned projection maps them into the 7168-wide backbone.
seq_len counts the full backbone sequence (patches + text).

A copy of ``repro.configs.llava_next_34b`` (the port imports nothing of the
JAX package); tests/test_torch_lm.py holds the fields equal.
``shard_attn_batch`` makes a prefill over a device mesh context-parallel:
each ``model`` rank attends with its rows of the q sequence and all of k
and v (models/layers.py); one process ignores it."""

from repro_torch.models.layers import LMConfig

N_PATCHES = 2880          # anyres: 4 tiles + 1 base, 576 patches each
PATCH_DIM = 1024          # CLIP ViT-L/14 width

CONFIG = LMConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    n_patches=N_PATCHES, patch_embed_dim=PATCH_DIM,
    shard_attn_batch=True,
)

REDUCED = LMConfig(
    name="llava-next-34b-reduced", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, n_patches=8, patch_embed_dim=32,
    remat=False,
)
