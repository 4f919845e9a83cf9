"""Port of ``repro.checkpoint``: atomic on-disk checkpoints."""
