"""Port of ``repro.utils``: parameter-dict helpers."""
