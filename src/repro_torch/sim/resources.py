"""Model size of the paper's experiment (Sect. IV) — the constant the port
needs from ``repro.sim.resources``, kept here so the port imports nothing of
the JAX package.  The Eq. (8)-(11) time draws themselves live in
``sim/truncnorm.py`` and ``sim/engine.py``.
"""

PAPER_MODEL_BYTES = 18.3e6          # 4.6M params fp32 ~= 18.3 MB
PAPER_MODEL_BITS = PAPER_MODEL_BYTES * 8
