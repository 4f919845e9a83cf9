"""Port of ``repro.launch``: the serving entry points."""
