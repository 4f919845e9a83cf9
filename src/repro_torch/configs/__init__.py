"""Port of ``repro.configs``: the dense architectures' and
recurrentgemma-9b's configs (copies).
"""
