"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into its own shared library with a plain C
interface and loaded with ctypes (no PyTorch headers: a build takes
seconds, not minutes).  Libraries go to `build/esoo_torch/` beside the
package, named by a hash of the source, so an edited kernel is rebuilt and
an unchanged one is loaded as it is.  Nothing is built at import: the
first call that launches a kernel builds it, and `build_all` builds every
source at once with one nvcc process each.

Every launch of a hand-written kernel goes through `launch`: the one place
that calls a C entry, on the current stream of the tensors' device, checks
its return code and counts its device launches.  A module declares its
C launch entries once with `entries`: each entry's argument types before
the stream (the last argument of every launch entry) and the device
launches one call makes (2 for csrc/transform.cu, 4 for
csrc/orbital_vag.cu, 1 elsewhere).  The plan queries (the entries that
launch nothing) keep their own types in each module's `_lib()`.

The count (`launch_counts`, `reset_launch_counts`) is one per process.
Its key is `<source>.<kernel>`, the kernel being the C entry's name
without `esoo_` and its dtype tag (`gemm.matmul`,
`transform.transform`, `sigma_lists.alpha_gather`,
`orbital_vag.orbital_vag`, `orbital_vag.pair_asymmetry`), then
`.<route>` where the entry takes a route argument: the scans'
`gate_scan.gate_scan_fwd.smem`, `pair_scan.pair_scan_bwd.global`,
`prot_scan.prot_scan_fwd.smem` and the like.  A key never names the
dtype, and a kernel that never launched has no key.  A launch made while
a CUDA graph is captured runs only when the graph is replayed: inside
`recording()` it is counted into the recording instead, and each replay
`credit`s the recording to the count, so the count is the same whether a
kernel ran from a graph or was queued one launch at a time.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "esoo_torch")

TAGS = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64",
        torch.complex128: "c128"}     # a launch entry's dtype tag

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


_ENTRIES: dict = {}          # (source, C entry) -> (argtypes, launches)
_COUNTS = collections.Counter()
# the open recordings, innermost last; process-wide, not per thread: a
# captured backward launches from the autograd engine's own thread
_RECORDINGS: list = []


def entries(name: str, table: dict) -> None:
    """Declare csrc/<name>.cu's launch entries: {C entry: (the types of
    its arguments before the stream, the device launches one call
    makes)}.  Nothing is built or loaded."""
    for entry, spec in table.items():
        _ENTRIES[name, entry] = spec


@functools.cache
def _entry(name: str, entry: str) -> tuple:
    """(the typed C entry, its count's key, its launches a call)."""
    argtypes, launches = _ENTRIES[name, entry]
    fn = getattr(load(name), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    kernel = entry.removeprefix("esoo_").rpartition("_")[0]
    return fn, f"{name}.{kernel}", launches


def launch(name: str, entry: str, device: torch.device, *args,
           route: str = None) -> None:
    """Call csrc/<name>.cu's launch entry `entry` on `device` with `args`
    (a tensor as its data pointer, None as NULL) and the device's current
    stream; raise RuntimeError on a non-zero return; count its launches
    under its key, `.<route>` appended when given."""
    fn, key, launches = _entry(name, entry)
    # type(), not isinstance(), which goes through Tensor's metaclass at
    # several times the cost; a tensor subclass fails in ctypes, loudly
    args = [a.data_ptr() if type(a) is torch.Tensor else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csrc/{name}.cu: {entry} failed: CUDA error "
                           f"{rc}")
    counts = _RECORDINGS[-1] if _RECORDINGS else _COUNTS
    counts[key if route is None else f"{key}.{route}"] += launches


def launch_counts() -> dict:
    """The device launches since the last reset, by key (a copy)."""
    return dict(_COUNTS)


def reset_launch_counts() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def recording():
    """Inside the block, launches are counted into the Counter it yields
    and not into the process-wide count (wrap a CUDA graph's capture in
    it, and `credit` the Counter at each replay)."""
    rec = collections.Counter()
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.pop()


def credit(counts: collections.Counter) -> None:
    """Add a recording's launches to the count (a replay of its graph)."""
    _COUNTS.update(counts)


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count
