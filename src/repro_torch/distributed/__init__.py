"""Client sharding of the bandit state (the port of ``repro.distributed``)."""
