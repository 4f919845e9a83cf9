"""Port of ``repro.models``: the paper's CIFAR CNN, the dense LMs
(layers, transformer, registry) and the griffin family (griffin)."""
