"""The six covariant PM6 checkpoints evaluated greedily in both packages on
the CPU from shared draws: the protocol, tolerances and ring ties of
tests/test_torch_shared_draws.py, which holds the device-LJ ones. sf6_pm6
is played as test_torch_host_rollout.py plays it, the rest through each
package's driver (test_torch_driver_checkpoints.py::evaluate_both), the
reward computed by the port's build of csrc/ in both packages. The file
reads experiments/ and writes nothing there."""
import pytest

from .test_torch_host_reward import \
    jax_library_built_from_csrc  # noqa: F401  (module fixture)
from .test_torch_host_reward import one_torch_thread  # noqa: F401
from .test_torch_host_rollout import SF6_PM6
from .test_torch_shared_draws import check
from .test_torch_shared_draws import \
    shared_greedy_draws  # noqa: F401  (module fixture)

CASES = {
    'sf6_pm6': ('pm6', SF6_PM6),
    'qm9_pm6': ('driver', None),
    'halides_pm6': ('driver', None),
    'organics_pm6': ('driver', None),
    'stochastic_pm6-run-1': ('driver', None),
    'stochastic_pm6-run-2': ('driver', None),
}


@pytest.mark.parametrize('name', list(CASES))
def test_pm6_greedy_evaluation_from_shared_draws_is_the_same(name):
    check(name, *CASES[name])
