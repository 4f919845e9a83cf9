"""PyTorch + CUDA port of the ``repro`` JAX package.

The JAX package (``src/repro``) is the reference; this package mirrors its
layout module by module and imports nothing of it.  Entry points run on the
card unless the caller passes ``device="cpu"``.  See README.md for the
module map.
"""
