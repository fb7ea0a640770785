"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes each kernel's work needs, from its shapes.

Copied from chip_smoke.py (the kernels phase: `_PEAKS`, `GATE_SCAN_OPS`,
the one-pass transform's `k2_bytes`/`k2_flops`, and `_gate_scan_kernels`'
`tables`/`nbytes`/`ops`), so that later changes to that script cannot
move the benchmark.  Each input is counted read once and each output
written once; a bound is the longer of bytes over the memory rate and
operations over the arithmetic rate.  portbench/tests/test_roofline.py
holds these functions to chip_smoke.py's expressions at the cells'
shapes.
"""

from __future__ import annotations

# published NVIDIA H100 SXM peaks (data sheet, dense, 700 W): HBM3 bytes/s
# and the float32 CUDA-core FLOP/s (the port's kernels use no tensor
# cores; float64 at half the float32 rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67.0e12

# operations an amplitude and gate of the string gate scan K3
# (csrc/gate_scan.cu): M and S (3 each), the update (6) forward; M, S,
# V_{k-1}, perm(V_{k-1}), the dtheta term and its sum, and W's update
# backward
GATE_SCAN_OPS = {"fwd": 12, "bwd": 31}


def arithmetic_rate(itemsize: int) -> float:
    return PEAK_F32_FLOP_PER_S if itemsize <= 4 else PEAK_F32_FLOP_PER_S / 2


def bound_s(nbytes: float, flops: float, itemsize: int = 4) -> float:
    """The least time the card needs: bytes at the memory rate or
    operations at the arithmetic rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / arithmetic_rate(itemsize))


def transform_bytes(m: int, n: int, itemsize: int = 4) -> int:
    """The 4-index transform g (m^4) -> U^T..U (n^4): g and U read once,
    the result written once."""
    return itemsize * (m ** 4 + m * n + n ** 4)


def transform_flops(m: int, n: int) -> int:
    """Its four one-index contractions (an FMA counts two)."""
    return 2 * (m * m * (m * m * n + m * n * n) + m * (m * n ** 3 + n ** 4))


def gate_scan_bytes(nB: int, nA: int, gates: int, itemsize: int = 4,
                    states: int = 1) -> dict:
    """Bytes a direction of K3 must move: the factored tables, c and s, the
    states in and out, and the backward's (B, K) partials."""
    nd = nB * nA
    tables = gates * (nA + nB) * (4 + 4 * itemsize) + 2 * gates * itemsize
    return {"fwd": tables + 2 * states * nd * itemsize,
            "bwd": tables + 3 * states * nd * itemsize
            + states * gates * itemsize}


def gate_scan_flops(nB: int, nA: int, gates: int, states: int = 1) -> dict:
    return {d: GATE_SCAN_OPS[d] * states * nB * nA * gates
            for d in ("fwd", "bwd")}
