"""Port of ``repro.kernels``: the bandit-round kernel, its plain
version and the routing between them."""
