"""Port of ``repro.kernels``: the bandit-round, top-S, UCB-score,
FedAvg-combine and attention kernels, their plain versions and the routing
between them."""
