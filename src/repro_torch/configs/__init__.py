"""Port of ``repro.configs``: the dense architectures' configs (copies).
"""
