"""One ERI engine on both sides of every port-against-JAX comparison.

esoo_tpu's native loader (esoo_tpu/native/loader.py) compiles
`_mcmurchie.so` with g++ straight onto its final path, and on the first
failed load it falls back to the pure-Python engine for the rest of the
process.  Under pytest-xdist one worker can find another worker's
half-written library, and its JAX chemistry then runs on the Python engine
while the port's loader (temp file, then rename) runs native: the
last-bit differences between the engines flip MO signs and SCF paths and
break the bit-for-bit comparisons (max |d eri_mo| = 0.31336 at H3 6-31G).

`same_eri_engine` is imported by every tests/test_torch_*.py that builds
an esoo_tpu.chem problem.  Under a file lock shared by all workers it
loads esoo_tpu's native engine, retrying while another process is still
writing the library, and asserts that both packages run the same engine.
esoo_tpu itself is left as it is."""

import fcntl
import os
import shutil
import time

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOCK = os.path.join(_ROOT, "build", "esoo_torch", "jax_native_engine.lock")
_QUIET_SECONDS = 2.0       # a library written this recently may be partial
_STALE_SECONDS = 10.0      # an unloadable library this old is abandoned


def _settled(path: str) -> bool:
    return (not os.path.exists(path)
            or time.time() - os.path.getmtime(path) >= _QUIET_SECONDS)


def load_jax_native_engine(timeout: float = 120.0) -> bool:
    """Load esoo_tpu's native ERI engine in this process (bounded retry
    while another process builds it); True when it is loaded."""
    from esoo_tpu.native import loader as jl
    os.makedirs(os.path.dirname(_LOCK), exist_ok=True)
    deadline = time.monotonic() + timeout
    with open(_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                if jl._lib is not None:
                    return True
                if shutil.which("g++") is None:
                    return jl._load() is not None
                if _settled(jl._SO):
                    with jl._lock:
                        jl._tried, jl._lib = False, None
                    if jl._load() is not None:
                        return True
                    if os.path.exists(jl._SO) and \
                            time.time() - os.path.getmtime(jl._SO) \
                            >= _STALE_SECONDS:
                        os.unlink(jl._SO)      # left half-written: rebuild
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.5)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def port_engine_is_native() -> bool:
    from esoo_torch.native import loader as tl
    return tl._load() is not None


@pytest.fixture(scope="session", autouse=True)
def same_eri_engine():
    """Both packages on the same ERI engine before any esoo_tpu.chem
    build in this process."""
    from esoo_tpu.native import loader as jl
    load_jax_native_engine()
    assert jl.native_available() == port_engine_is_native()


def test_both_packages_run_the_same_engine():
    from esoo_tpu.native import loader as jl
    assert jl.native_available() == port_engine_is_native()


def test_a_process_left_on_the_python_engine_is_recovered():
    """The fault's state (a failed load marked as tried) is undone."""
    from esoo_tpu.native import loader as jl
    if not port_engine_is_native():
        pytest.skip("no C++ compiler: both packages run the Python engine")
    saved = jl._lib
    with jl._lock:
        jl._tried, jl._lib = True, None
    try:
        assert not jl.native_available()
        assert load_jax_native_engine()
        assert jl.native_available()
    finally:
        if jl._lib is None:
            jl._lib = saved


def test_h2_eri_bitwise_equal_across_packages():
    import esoo_torch.chem as TC
    import esoo_tpu.chem as JC
    geom = "H 0 0 0; H 0 0 0.735"
    tp = TC.MoleculeDriver(geom, basis="6-31g").run()
    jp = JC.MoleculeDriver(geom, basis="6-31g").run()
    np.testing.assert_array_equal(tp.eri_mo, jp.eri_mo)
