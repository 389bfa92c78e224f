"""Build and load the hand-written CUDA kernels under ops/csrc/.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` for
Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`. Builds go
to `build/` at the repository root, keyed by a hash of the source and the
flags, at first use: a fresh checkout builds everything on its first kernel
call (seconds per file). Nothing here runs at import time. The wrappers hand
tensors to a launch through ptr, stream and check_cuda, and raise_on turns
its return code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each library built by this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')


def _target(name: str) -> Path:
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f'lib{name}_{digest}.so'


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together. Returns the seconds each build took."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'{name}:\n{log}')
        else:
            os.replace(tmp, so)   # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(name: str, device: torch.device, **tensors):
    """Device, dtype and contiguity checks before a raw pointer is handed to
    a kernel."""
    for key, (t, dtype) in tensors.items():
        if t.device != device:
            raise ValueError(f'{name}: {key} is on {t.device}, expected {device}')
        if t.dtype not in dtype:
            raise TypeError(f'{name}: {key} has dtype {t.dtype}, expected '
                            f'one of {dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {key} must be contiguous')


def raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error {rc}')
