"""Build + load the native integral engine (host C++) via ctypes.

Frozen copy of esoo_torch/native/loader.py for the benchmark's inputs.
mcmurchie.cpp is compiled with g++ at first use into `portbench/build/`
(a fixed directory inside the checkout), named by a hash of the source
and the host; if no compiler is available the caller falls back to the
pure-Python engine (much slower with f shells).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "mcmurchie.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

_FLAG_SETS = (
    ["-O3", "-march=native", "-fPIC", "-shared", "-fopenmp", "-std=c++17"],
    # retry without -march=native / openmp for maximum portability
    ["-O3", "-fPIC", "-shared", "-std=c++17"],
)


def _so_path() -> str:
    """Keyed on the source and the host (-march=native code from another
    machine may not run here)."""
    with open(_SRC, "rb") as f:
        key = f.read() + f"{platform.node()} {platform.machine()}".encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"mcmurchie-{digest}.so")


def _build(dst: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    for flags in _FLAG_SETS:
        try:
            subprocess.run(["g++", *flags, _SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
        os.replace(tmp, dst)
        return True
    os.unlink(tmp)
    return False


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    so = _so_path()
    if not os.path.exists(so) and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.esoo_eri_cart.restype = ctypes.c_int
    lib.esoo_eri_cart.argtypes = [
        ctypes.c_int,                     # nshell
        ctypes.POINTER(ctypes.c_int),     # l
        ctypes.POINTER(ctypes.c_double),  # centers
        ctypes.POINTER(ctypes.c_int),     # nprim
        ctypes.POINTER(ctypes.c_int),     # prim_off
        ctypes.POINTER(ctypes.c_double),  # exps
        ctypes.POINTER(ctypes.c_double),  # coefs
        ctypes.POINTER(ctypes.c_double),  # out
        ctypes.c_int,                     # nbf
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def get_native_eri():
    """Returns eri_cart(shells) -> ndarray, or None if unavailable.

    `shells` are basis.Shell objects; the result is the
    full contracted CARTESIAN ERI tensor (chemist ordering) — the
    spherical transformation stays in Python.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        return None

    def eri_cart(shells):
        nshell = len(shells)
        l = np.array([sh.l for sh in shells], dtype=np.int32)
        centers = np.ascontiguousarray(
            np.array([sh.center for sh in shells], dtype=np.float64))
        nprim = np.array([len(sh.exps) for sh in shells], dtype=np.int32)
        prim_off = np.zeros(nshell, dtype=np.int32)
        np.cumsum(nprim[:-1], out=prim_off[1:])
        exps = np.ascontiguousarray(
            np.concatenate([sh.exps for sh in shells]).astype(np.float64))
        coefs = np.ascontiguousarray(
            np.concatenate([sh.cnorm for sh in shells]).astype(np.float64))
        nbf = int(sum(sh.ncart for sh in shells))
        out = np.zeros((nbf, nbf, nbf, nbf), dtype=np.float64)

        rc = lib.esoo_eri_cart(
            nshell,
            l.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nprim.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            prim_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            exps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nbf,
        )
        if rc != 0:
            raise RuntimeError(f"native ERI engine failed (rc={rc})")
        return out

    return eri_cart
