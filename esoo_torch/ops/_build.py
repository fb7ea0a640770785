"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into its own shared library with a plain C
interface and loaded with ctypes (no PyTorch headers: a build takes
seconds, not minutes).  Libraries go to `build/esoo_torch/` beside the
package, named by a hash of the source, so an edited kernel is rebuilt and
an unchanged one is loaded as it is.  Nothing is built at import: the
first call that launches a kernel builds it, and `build_all` builds every
source at once with one nvcc process each.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "esoo_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels are built from csrc/ at first use")


def _source(name: str) -> str:
    path = os.path.join(CSRC, f"{name}.cu")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def library_path(name: str) -> str:
    """Where the built library of csrc/<name>.cu lives (hash-keyed)."""
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp, dst) or None when
    the library is already built."""
    dst = library_path(name)
    if os.path.exists(dst):
        return None
    nvcc, src = _nvcc(), _source(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, dst


def _finish(name: str, started, timeout: float = 600.0) -> None:
    if started is None:
        return
    proc, tmp, dst = started
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{out}")
    os.replace(tmp, dst)     # atomic: concurrent builders never see a stub


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def build_all() -> list:
    """Build every csrc/*.cu, one nvcc each, all started together."""
    names = sources()
    started = [(n, _start(n)) for n in names]
    for n, s in started:
        _finish(n, s)
    return names


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, building it if needed."""
    _finish(name, _start(name))
    return ctypes.CDLL(library_path(name))
