"""Build the native host library (the C++ reward calculators of
`molgym_tpu_torch/csrc/host/`) with g++ at first use.

The three sources `csrc/host/molgym_host.cpp`, `eht.cpp` and `nddo.cpp` are
the port's copies of the JAX package's `csrc/` sources, equal to them but
for the `#include` lines they lacked and one repair: molgym_host.cpp's
thread pool signals a batch's condition variable under its mutex, where
the original's caller could destroy it first
(tests/test_torch_package.py holds them so; tests/test_torch_host_pool.py
checks the pool under ThreadSanitizer). They compile with the JAX package's Makefile flags into
`_build/libmolgym_host-<hash>.so`. The hash covers the sources, the
compiler, the flags and this host's CPU identity: the library is built
`-march=native`, so one built on another CPU may not run here, and its SCF
may converge to another UHF basin on near-degenerate clusters. A build
writes a temporary file and moves it into place with `os.replace`, so
processes that build at once each load a whole library. A failed build
raises with the compiler's output; nothing stale is loaded in its place,
and nothing is written beside the sources.
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

from molgym_tpu_torch.cuda_build import BUILD_DIR

CSRC = Path(__file__).resolve().parent / 'csrc' / 'host'
SOURCES = ('molgym_host.cpp', 'eht.cpp', 'nddo.cpp')
# the JAX package's csrc/Makefile: its CXXFLAGS and its -shared
CXXFLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall', '-pthread',
            '-shared')


def cpu_key() -> str:
    """This host's CPU identity: its model names and feature flags from
    /proc/cpuinfo (the processor and machine names where there is none)."""
    try:
        with open('/proc/cpuinfo') as f:
            lines = [ln for ln in f if ln.startswith(('model name', 'flags'))]
        return ''.join(sorted(set(lines)))
    except OSError:
        return platform.processor() + platform.machine()


def _compiler() -> str:
    return os.environ.get('CXX', 'g++')


def library_path(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of `csrc`'s sources lives, for this compiler, these
    flags and this CPU."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((csrc / name).read_bytes())
    digest.update(' '.join((_compiler(), ) + CXXFLAGS).encode())
    digest.update(cpu_key().encode())
    return build_dir / f'libmolgym_host-{digest.hexdigest()[:16]}.so'


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """The library of `csrc`'s sources, compiled into `build_dir` unless a
    current one is there. Raises RuntimeError with the compiler's output
    when the build fails."""
    target = library_path(csrc, build_dir)
    if target.exists():
        return target
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_compiler(), *CXXFLAGS, '-o', str(tmp),
           *(str(csrc / name) for name in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f'host library build failed: {exc}') from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'host library build failed ({" ".join(cmd)}, exit '
                           f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, target)
    return target
