"""Port of ``repro.core``: the bandit state and round steps."""
