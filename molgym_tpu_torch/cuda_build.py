"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`_build/lib<name>-<hash>.so` (the hash covers the source, the headers of
`csrc/` it may include and the flags, so an edited source or header builds
anew). Nothing is built at import time: the first call
to `load` builds, and `build` starts one nvcc per source at once, so a
caller that needs several kernels pays for the slowest build only.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
KERNEL_SOURCES = ('cg_aggregate', 'cg_square', 'cg_aggregate_bwd',
                  'cg_square_bwd', 'cg_product', 'cg_product_bwd',
                  'masked_softmax')


def _nvcc() -> str:
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    for cand in (shutil.which('nvcc'), os.path.join(cuda_home, 'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found on PATH or under CUDA_HOME; the CUDA '
                       'toolkit is needed to build the port\'s kernels')


def library_path(name: str) -> Path:
    text = b''.join(p.read_bytes() for p in
                    [CSRC / f'{name}.cu', *sorted(CSRC.glob('*.cuh'))])
    digest = hashlib.sha256(text +
                            ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}-{digest}.so'


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Compile every named source that has no current library, all nvcc
    processes at once. Returns {name: {'seconds', 'ptxas'}} for the sources
    built by this call; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    start = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    report = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'{name}: nvcc exit {proc.returncode}\n{log}')
            continue
        os.replace(tmp, target)
        report[name] = {'seconds': time.perf_counter() - start,
                        'ptxas': [ln.strip() for ln in log.splitlines()
                                  if 'ptxas info' in ln]}
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
