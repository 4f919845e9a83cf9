"""Port of ``repro.optim``: the paper's SGD schedule."""
