"""Port of ``repro.sim``: scenarios, Eq. (8) sampling, the sweep."""
