"""Port of ``repro.kernels``: the bandit-round, top-S, UCB-score,
FedAvg-combine, attention and RG-LRU scan kernels, their plain versions and
the routing between them."""
