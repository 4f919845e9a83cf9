"""Port of ``repro.configs``: every architecture's config (copies).
"""
