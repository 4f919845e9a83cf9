"""Port of ``repro.models``: the paper's CIFAR CNN and the dense LMs
(layers, transformer, registry)."""
