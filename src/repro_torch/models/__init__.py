"""Port of ``repro.models``: the paper's CIFAR CNN."""
