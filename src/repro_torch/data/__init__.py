"""Port of ``repro.data``: the synthetic CIFAR task and its client split."""
