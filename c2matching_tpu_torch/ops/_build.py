"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers) and
compiles on its own into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout. ``<hash>`` covers the source, every ``csrc/*.cuh`` header it
includes (``#include "..."``, followed into headers), the flags and any
macros defined for a build (``defines``: a measurement's variant of a
source), so an edited source or header rebuilds and an unchanged one is
loaded from the cache. A source of another checkout (``src``: an earlier
tree's kernel, timed beside this one's) builds into the same directory
under its own hash. The build
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
SOURCES = ('patch_match', 'deform_conv', 'deform_conv_backward',
           'deform_conv_fused', 'dcn_window', 'conv_epilogue')

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
    """The headers beside ``path`` (``csrc/``) that it includes, directly
    or through another header, in the order first met."""
    path = Path(path)
    seen = []
    todo = [path]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop(0).read_bytes()):
            header = path.parent / name.decode()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def _flags(defines):
    return NVCC_FLAGS + tuple(f'-D{d}' for d in defines)


def source(name, src=None):
    """The path of kernel source ``name``: ``csrc/<name>.cu``, or ``src``
    where given."""
    return Path(src) if src else CSRC / f'{name}.cu'


def library_path(name, defines=(), src=None):
    src = source(name, src)
    digest = hashlib.sha256(src.read_bytes())
    for header in local_headers(src):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(' '.join(_flags(defines)).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(names=SOURCES, verbose=False):
    """Compile every named source whose library is missing: one nvcc per
    source, all started together. ``names`` holds source names, (name,
    defines) pairs or (name, defines, src) triples, ``defines`` a tuple of
    ``'MACRO=value'`` strings and ``src`` the path of another checkout's
    source of that name.
    Returns ``{name: compiler output}`` for the builds made now (with
    ``verbose``, ptxas reports registers, shared memory and spills). Raises
    with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ('-Xptxas', '-v') if verbose else ()
    procs = {}
    for entry in names:
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        name, defs, src = entry + ((), None)[len(entry) - 1:]
        out = library_path(name, defs, src)
        if out.exists():
            continue
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *_flags(defs), *extra, '-o', str(tmp),
               str(source(name, src))]
        if src:
            name = f'{name} of {src}'
        if defs:
            name = f'{name} ({" ".join(defs)})'
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


def load(name, defines=(), src=None):
    """The ctypes handle of kernel library ``name`` (built with the macros
    ``defines``, from ``src`` where given), built on first use."""
    key = (name, tuple(defines), src)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build((key,))
            lib = ctypes.CDLL(str(library_path(*key)))
            _libs[key] = lib
        return lib
