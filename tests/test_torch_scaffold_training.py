"""The port's scaffold training path against the JAX package step by step,
at the recorded run's full configuration (tests/torch_family_training.py
has the tests, their tolerances and the family's configuration): A1 the
rollout loop replayed through the JAX env, A2 three successive PPO
iterations, A3 the sampled heads' distributions, their two-package
comparison and the planted faults that the statistics must reject."""
import pytest

from .torch_family_training import (  # noqa: F401  (collected here)
    Family, draws, one_torch_thread,
    test_head_distributions_match_the_jax_package,
    test_planted_faults_are_rejected,
    test_rollout_replays_through_the_jax_env,
    test_sampled_heads_draw_from_their_distributions,
    test_successive_ppo_updates_match_the_jax_package,
    test_the_two_packages_draw_alike)


@pytest.fixture(scope='module')
def family():
    return Family('scaffold')
