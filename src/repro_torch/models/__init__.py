"""Port of ``repro.models``: the paper's CIFAR CNN, the decoder-only LMs
(layers, transformer: dense, moe, vlm), the registry, and the griffin,
xlstm and encdec families."""
