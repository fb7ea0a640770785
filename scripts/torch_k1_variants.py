"""The ring shape of K1's narrow kernel (esoo_torch/csrc/gemm.cu,
gemm_narrow_ring) on one NVIDIA GPU: builds variants of gemm.cu that differ
only in kRing (stages in the ring), kStageK (k-rows a stage) and the
blocks an SM of __launch_bounds__, each also in a copy-only form (the FMAs
switched off, so the time is that of the copies and the stores alone), and
times them (float32) at stage 1 of the transform at m=112 for n = 4, 14
and 16, at stages 2 to 4 of (m, n) = (112, 16) and at H4's stage 1
(56, 4), whose 42 MB x stays in the 50 MB L2.

    python3 scripts/torch_k1_variants.py

Builds under build/k1_variants/ (nvcc, one process a variant, all started
together).  Times are the kernel's device time (torch.profiler, mean of 20
calls, chip_smoke.kernel_ms), two rounds; beside them torch.matmul(x.T, u)
and x.sum() (a read of stage 1's 629 MB x alone), by CUDA events around 30
back-to-back calls.  Prints one JSON line a variant and round.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "esoo_torch", "csrc", "gemm.cu")
OUT = os.path.join(HERE, "build", "k1_variants")
# (kRing, kStageK, blocks an SM)
SHAPES = [(2, 16, 1), (3, 16, 1), (3, 8, 1), (2, 8, 2), (4, 4, 2)]


def variant(ring: int, stage_k: int, per_sm: int, copy_only: bool) -> str:
    src = open(SRC).read()
    for old, new in (
            ("constexpr int kRing = 2;", f"constexpr int kRing = {ring};"),
            ("constexpr int kStageK = 16;",
             f"constexpr int kStageK = {stage_k};"),
            ("__launch_bounds__(kThreads, 1)\ngemm_narrow_ring",
             f"__launch_bounds__(kThreads, {per_sm})\ngemm_narrow_ring")) + (
            (("    if (active) {\n      const V* xs",
              "    if (active && K < 0) {\n      const V* xs"),)
            if copy_only else ()):
        if old not in src:
            raise AssertionError(f"gemm.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for ring, stage_k, per_sm in SHAPES:
        for copy_only in (False, True):
            name = f"ring{ring}_k{stage_k}_b{per_sm}" + (
                "_copy_only" if copy_only else "")
            path = os.path.join(OUT, name + ".cu")
            with open(path, "w") as f:
                f.write(variant(ring, stage_k, per_sm, copy_only))
            procs[name] = subprocess.Popen(
                ["/usr/local/cuda/bin/nvcc", "-gencode",
                 "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-o",
                 os.path.join(OUT, name + ".so"), path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        lib.esoo_matmul_f32.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        libs[name] = lib

    sys.path.insert(0, HERE)
    from chip_smoke import kernel_ms
    dev, m = torch.device("cuda"), 112
    # (name, x (K, M), n): stage 1 at m=112 for three n; stages 2-4 at
    # (112, 16); H4's stage 1 (56, 4), L2-resident
    xs = {"stage1": torch.randn(m, m ** 3, device=dev),
          "stage2": torch.randn(m, m * m * 16, device=dev),
          "stage3": torch.randn(m, m * 16 * 16, device=dev),
          "stage4": torch.randn(m, 16 ** 3, device=dev),
          "h4": torch.randn(56, 56 ** 3, device=dev)}
    cases = [("stage1", 4), ("stage1", 14), ("stage1", 16), ("stage2", 16),
             ("stage3", 16), ("stage4", 16), ("h4", 4)]

    def run(lib, x, u):
        K, M = x.shape
        out = torch.empty(M, u.shape[1], device=dev)
        rc = lib.esoo_matmul_f32(x.data_ptr(), u.data_ptr(), out.data_ptr(),
                                 M, K, u.shape[1], 1,
                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    def events_ms(fn, reps=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for rnd in range(2):
        for name, lib in libs.items():
            rec = {"variant": name, "round": rnd, "card": card}
            for shape, n in cases:
                x = xs[shape]
                u = torch.randn(x.shape[0], n, device=dev)
                if not name.endswith("copy_only"):
                    ref = x.T @ u
                    err = float((run(lib, x, u) - ref).abs().max())
                    if err > 5e-6 * max(1.0, float(ref.abs().max())):
                        raise AssertionError(f"{name} {shape} n={n}: {err}")
                rec[f"{shape}_n{n}_kernel_ms"] = kernel_ms(
                    lambda: run(lib, x, u), match="gemm_narrow")
            print(json.dumps(rec), flush=True)
    x, u = xs["stage1"], torch.randn(m, 16, device=dev)
    print(json.dumps({"torch_matmul_stage1_n16_ms": events_ms(
        lambda: x.T @ u), "x_sum_ms": events_ms(lambda: x.sum()),
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
