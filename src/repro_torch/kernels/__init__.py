"""Port of ``repro.kernels``: the bandit-round and FedAvg-combine kernels,
their plain versions and the routing between them."""
