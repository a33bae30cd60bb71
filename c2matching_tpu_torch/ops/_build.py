"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
compiles on its own into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout. ``<hash>`` covers the source, every ``csrc/*.cuh`` header it
includes (``#include "..."``, followed into headers) and the flags, so an
edited source or header rebuilds and an unchanged one is loaded from the
cache. The build
happens at first use, never at import: the CPU tests import every module
on hosts without nvcc.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')
SOURCES = ('patch_match', 'deform_conv', 'dcn_window')

_libs = {}
_lock = threading.Lock()


def nvcc_path():
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    candidate = Path(cuda_home) / 'bin' / 'nvcc'
    if candidate.exists():
        return str(candidate)
    raise RuntimeError('nvcc not found (looked on PATH and in CUDA_HOME/bin)')


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(path):
    """The ``csrc/`` headers that ``path`` includes, directly or through
    another header, in the order first met."""
    seen = []
    todo = [path]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_bytes()):
            header = CSRC / name.decode()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(name):
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names=SOURCES, verbose=False):
    """Compile every named source whose library is missing: one nvcc per
    source, all started together. Returns ``{name: compiler output}`` for
    the sources built now (with ``verbose``, ptxas reports registers,
    shared memory and spills). Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ('-Xptxas', '-v') if verbose else ()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n'
                           + '\n'.join(logs[n] for n in failed))
    return logs


def load(name):
    """The ctypes handle of kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
