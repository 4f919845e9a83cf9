"""The port's numpy copies of the scenario registry and network model give
byte-identical environments to the JAX package's, so a scenario name and an
env seed mean the same clients in both packages."""

import dataclasses

import numpy as np
import pytest
import _torch_dist  # noqa: E402

one_thread = pytest.fixture(autouse=True, scope="module")(
    _torch_dist.one_thread)

pytest.importorskip("torch")

from repro.sim import resources as jax_resources  # noqa: E402
from repro.sim import scenarios as jax_scenarios  # noqa: E402
from repro_torch.sim import resources, scenarios  # noqa: E402


def test_registry_matches():
    assert list(scenarios.SCENARIOS) == list(jax_scenarios.SCENARIOS)
    for name, scen in scenarios.SCENARIOS.items():
        want = jax_scenarios.SCENARIOS[name]
        got = dataclasses.asdict(scen)
        assert got == dataclasses.asdict(want), name
        assert scen.fault.probs == want.fault.probs
    assert resources.PAPER_MODEL_BITS == jax_resources.PAPER_MODEL_BITS


@pytest.mark.parametrize("name", list(jax_scenarios.SCENARIOS))
def test_build_env_and_cells_byte_identical(name):
    for n, seed in ((1, 0), (100, 0), (1000, 7)):
        got = scenarios.get_scenario(name).build_env(
            n, np.random.default_rng(seed))
        want = jax_scenarios.get_scenario(name).build_env(
            n, np.random.default_rng(seed))
        for field in ("dist_m", "mean_throughput_bps", "mean_capability",
                      "n_samples"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
        a = scenarios.get_scenario(name).cell_ids(n)
        b = jax_scenarios.get_scenario(name).cell_ids(n)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_unknown_scenario_and_bad_fault_raise():
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.get_scenario("no-such-scenario")
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        scenarios.FaultModel(crash_prob=1.5)
