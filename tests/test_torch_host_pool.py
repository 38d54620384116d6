"""The thread pool of the port's host library
(molgym_tpu_torch/csrc/host/molgym_host.cpp, ThreadPool::run_batch) under
ThreadSanitizer: a small C++ driver calls mg_batch_reward on a batch of
10 molecules again and again, and the sanitizer must report nothing.

The JAX package's original (csrc/molgym_host.cpp, compiled from a
temporary copy, never edited) signals the batch's condition variable
after releasing its mutex, so the caller can see every shard done, return
and destroy that local before the signal lands: a use-after-scope that
crashed a PM6 rollout on the card now and then. The port's copy signals
under the mutex. The second case holds the sanitizer to finding the race
in the original, so the first case's silence means something. Needs g++
with libtsan; writes only under pytest's tmp_path."""
import os
import shutil
import subprocess
from pathlib import Path

import pytest

from molgym_tpu_torch import host_build

REPO_CSRC = Path(__file__).resolve().parents[1] / 'csrc'

DRIVER = r'''
#include <cstdlib>
#include <vector>
extern "C" int mg_batch_reward(int, int, const int*, const double*,
                               const int*, const int*, const double*,
                               const unsigned char*, int, double, double*);
int main(int argc, char** argv) {
  const int n_mols = 10, max_atoms = 4, calls = std::atoi(argv[1]);
  std::vector<int> zs(n_mols * max_atoms, 0), n_atoms(n_mols, 1),
      new_z(n_mols, 1);
  std::vector<double> pos(n_mols * max_atoms * 3, 0.0), new_pos(n_mols * 3),
      rewards(n_mols);
  std::vector<unsigned char> valid(n_mols, 1);
  for (int m = 0; m < n_mols; ++m) {
    zs[m * max_atoms] = 8;
    new_pos[3 * m] = 1.0 + 0.01 * m;
  }
  for (int c = 0; c < calls; ++c)  // Lennard-Jones: the pool, not the SCF
    mg_batch_reward(n_mols, max_atoms, zs.data(), pos.data(), n_atoms.data(),
                    new_z.data(), new_pos.data(), valid.data(), 0, 1.0,
                    rewards.data());
  return 0;
}
'''
CALLS = 400
RACE = 'WARNING: ThreadSanitizer: data race'


def sanitized_run(sources: Path, tmp_path: Path) -> subprocess.CompletedProcess:
    """The driver linked with `sources`' three files under
    -fsanitize=thread, run for CALLS calls; stops at the first report."""
    (tmp_path / 'driver.cpp').write_text(DRIVER)
    exe = tmp_path / 'driver'
    subprocess.run(
        [os.environ.get('CXX', 'g++'), '-O1', '-g', '-std=c++17', '-pthread',
         '-fsanitize=thread', '-include', 'cstdio', '-o', str(exe),
         str(tmp_path / 'driver.cpp')]
        + [str(sources / name) for name in host_build.SOURCES],
        check=True, capture_output=True, text=True)
    return subprocess.run(
        [str(exe), str(CALLS)], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TSAN_OPTIONS='halt_on_error=1 exitcode=66'))


def test_the_ports_pool_has_no_race(tmp_path):
    run = sanitized_run(host_build.CSRC, tmp_path)
    assert RACE not in run.stderr, run.stderr[:4000]
    assert run.returncode == 0, run.stderr[:4000]


def test_the_sanitizer_finds_the_originals_race(tmp_path):
    """The JAX package's molgym_host.cpp beside the port's other two
    sources: the race between the caller's pthread_cond_destroy and a
    worker's pthread_cond_signal in run_batch is reported."""
    sources = tmp_path / 'sources'
    sources.mkdir()
    for name in host_build.SOURCES:
        shutil.copy(host_build.CSRC / name, sources / name)
    shutil.copy(REPO_CSRC / 'molgym_host.cpp', sources / 'molgym_host.cpp')
    run = sanitized_run(sources, tmp_path)
    assert run.returncode == 66
    assert RACE in run.stderr and 'run_batch' in run.stderr
    assert 'pthread_cond_destroy' in run.stderr
