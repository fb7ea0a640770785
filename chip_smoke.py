#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (esoo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py       # from the repository root

Phases, one JSON line each:
  device    card name and power limit, torch/CUDA versions, build times
            (nvcc for every csrc/*.cu and g++ for the ERI engine, all
            started together);
  kernels   each hand-written kernel against its plain PyTorch version at
            the main paths' shapes (stated tolerances), both routes of the
            transform (the one-pass kernel for n <= 8, the four-launch
            GEMM chain beyond, at the CASSCF shapes m=112, n=14 and 16),
            and its time beside its bound, the plain version's and the
            library call's (the transform also beside the chain's, in the
            same run); K1's narrow kernel also at NARROW_SHAPES (two calls
            bit for bit), at stage 1 of m=112 for n = 4, 8, 12, 14 and
            16, and at each of the chain's four stages;
  main path FusedOptOrbVQE on H4 cc-pVTZ (m=56 -> 8 spin orbitals,
            UCCSD, f32) with the launch counts zeroed before and read
            after; energy gates against the reference values; per-step
            costs of the eigensolver and the orbital step;
  profile   one more warm solve under torch.profiler: device busy share
            and device time by kernel;
  casscf    the second main path: FusedOptOrbCASSCF on H8 cc-pVTZ
            (m=112 -> 28 spin orbitals, 1,002,001 determinants, f32,
            maxiter 10) with the launch counts zeroed before and read
            after; gates on the energy (the JAX package's record, and the
            float64 energy at the final orbitals), on the Davidson
            residual and on the transform's route; the outer trace,
            stage_stats, peak memory and per-step costs of sigma, the
            diagonal, the RDMs and one BB iteration; float64 witnesses at
            the final orbitals (sigma's float32 error, the final vector's
            float64 residual, restarted float32 solves, one Rayleigh-Ritz
            step projected in float32 and in float64, the float64 energy);
  excited   the excited-state path: FusedOptOrbSSVQE on H4 cc-pVTZ
            (m=56 -> 8, UCCSD, HF and the HOMO->LUMO alpha single, weights
            [2, 1], f32) cold and warm, with the launch counts zeroed
            before the cold run and read after; gates against the JAX
            package's float64 energies of the same configuration and the
            exact sector spectrum at the final orbitals; one L-BFGS
            evaluation's wall and device time.  Then H2 6-31G -> 4 at f64:
            SSVQE, MCVQE, VQD and AdaptVQE on the card against the port's
            CPU runs;
  compact   the third main path: FusedOptOrbCASSCF on H8 cc-pVTZ
            (m=112 -> 32 spin orbitals, 3,312,400 determinants, f32,
            maxiter 10) with the default table_storage='auto', which takes
            the compact int8 tables; before it, the compact and dense
            sigma, sigma operators, RDMs and diagonal held against each
            other on one vector at N=32 (and sigma at N=28), each timed
            with its extra peak memory; after it, the gates of the casscf
            phase and a float64 witness on compact float64 tables;
  parity    H2 6-31G -> 4 spin orbitals at f64 on the card against the
            reference energies and the port's own CPU run: FusedOptOrbVQE,
            FusedOptOrbCASSCF and FusedOptOrbSACASSCF (k=2).
Then the kernel table line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure raises (non-zero exit, no
result line); so does a machine without CUDA.  Imports nothing of JAX or
of the JAX package.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

H4_GEOM = "H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69"
H2_GEOM = "H 0 0 0; H 0 0 0.735"
H8_GEOM = "; ".join(f"H 0 0 {1.23 * i:.2f}" for i in range(8))  # bench.py:219
# reference energies (electronic, Hartree): the reference-faithful torch
# baseline and the JAX package's f64-refined H4 energy; the OptOrbVQE
# H2 6-31G -> 4 reference of the JAX package's tests
H4_BASELINE = -4.0408712
H4_REFERENCE = -4.0408844
H4_TOL = 1e-4
H2_REFERENCE = -1.8661038079694765
H2_TOL = 5e-4
# the JAX package's H8 cc-pVTZ -> 28 exact CASSCF, f32, dense tables,
# maxiter 10 (BENCH_r05.json h8_casscf_energy_f32, on a TPU)
H8_CASSCF_REFERENCE = -10.283001899719238
H8_CASSCF_TOL = 1e-3
# the float64 ground energy at the H8 solve's final orbitals against its
# float32 energy
H8_F64_WITNESS_TOL = 1e-4
# the JAX package's H8 cc-pVTZ -> 32 exact CASSCF, f32, compact int8
# tables, 10 outer iterations (docs/PERF.md:289 and :549, on a TPU):
# -10.285221 and -10.289289; the gate is the pair widened by 1e-3
H8_N32_WINDOW = (-10.2903, -10.2842)
# compact against dense storage on the card, float32: max|err| <=
# COMPACT_TOL * max(1, max|ref|); the two sum up to 2 n^2 ns = 4.7e5
# float32 products per entry in different orders (sqrt(4.7e5) float32
# ulps of the terms' scale is 4e-5)
COMPACT_TOL = 1e-5
# FusedOptOrbSSVQE on H4 cc-pVTZ -> 8 (UCCSD(4, (2, 2)); HartreeFock and
# the HOMO->LUMO alpha single, alpha qubits 0 and 2, beta 4 and 5;
# weights [2, 1]; maxiter 20, tol 1e-5): the JAX package at float64 on
# the CPU (esoo_tpu FusedOptOrbSSVQE, the second state a QuantumCircuit(8)
# with x on qubits 0, 2, 4 and 5), 5 outer iterations
H4_SSVQE_F64 = (-4.034691906888726, -3.7694916759726076)
H4_SSVQE_TOL = 1e-4
H4_EXCITED_MASK = 0b110101
# the fused excited-state anchors on H2 6-31G -> 4 (BASELINE.md; decimal 3)
H2_EXCITED_ANCHORS = {"ssvqe": (-1.85403538, -1.37044354),
                      "mcvqe": (-1.85703467, -1.46615986),
                      "vqd": (-1.8540352, -1.37044389),
                      "adapt": (-1.866104213792463,)}
H2_ANCHOR_TOL = 1.5e-3
# CASSCF on H2 6-31G -> 4 (tests/test_casscf.py:76, decimal 4) and the
# state-averaged k=2 pair, the OptOrbMCVQE reference values
# (tests/test_casscf.py:203, decimal 5)
H2_CASSCF_TOL = 1e-4
H2_SA_REFERENCE = (-1.85703467, -1.46615986)
H2_SA_TOL = 1.5e-5

# the narrow K1 kernel's check shapes (M, K, N), x^T y with x (K, M): N
# from 1 to 16; M ragged against a tile and not a multiple of 4; K of one
# ring stage, of 7 and of 19 (y in two chunks at float32, three at
# float64, N = 16)
NARROW_SHAPES = ([(729, 112, n) for n in (1, 4, 5, 8, 12, 14, 16)]
                 + [(4097, k, 16) for k in (1, 3, 112, 300)]
                 + [(729, 300, 5), (4098, 7, 14)])
# stage 1 of the transform's chain at m=112: the n of the sweep
K1_SWEEP_N = (4, 8, 12, 14, 16)

# published H100 peaks (NVIDIA data sheets): memory bytes/s and the
# float32 CUDA-core FLOP/s (the kernels use no tensor cores)
_PEAKS = (("PCIe", 2.0e12, 51.2e12), ("NVL", 3.9e12, 60.0e12),
          ("", 3.35e12, 67.0e12))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    for key, bw, fl in _PEAKS:
        if key in name:
            return bw, fl
    raise AssertionError("unreachable")


@functools.cache
def _spin_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep (a device spin) per millisecond."""
    import torch
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    stop.synchronize()
    return cycles / start.elapsed_time(stop)


def time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Device time per call: the median over `reps` back-to-back calls,
    after warm-up, of CUDA events recorded just before and just after each
    call.  The calls are queued behind a device spin that outlasts the
    host's enqueueing of all of them, so each pair of events brackets the
    call's device work alone and no host launch gap; if the spin ended
    before the last call was queued, it is lengthened and the run
    repeated."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    for attempt in range(4):
        spin_ms = (2.0 * host_ms + 20.0) * 4 ** attempt
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        spun = torch.cuda.Event()
        torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        spun.record()
        for start, stop in events:
            start.record()
            fn()
            stop.record()
        drained = spun.query()
        torch.cuda.synchronize()
        if not drained:
            times = sorted(s.elapsed_time(e) for s, e in events)
            return times[reps // 2]
    raise AssertionError("the device spin never outlasted the host's "
                         "enqueueing of the timed calls")


def _device_events(prof):
    """(name, microseconds) of every device-side event (kernels, copies)
    recorded by a torch.profiler run."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name, ev.time_range.end - ev.time_range.start)
            for ev in prof.events() if ev.device_type == cuda]


def device_profile(fn, reps: int = 20, match: str = ""):
    """(milliseconds, events) per call of the device kernels and copies
    whose name contains `match` (torch.profiler/CUPTI): the kernels'
    durations alone, without the gaps between kernels that `time_ms`
    includes.  A profiling window in which CUPTI delivered no device
    event at all (seen now and then on the card, for any kernel) is
    taken again, at most twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        if events:
            break
    times = [t for name, t in events if match in name]
    if not times:
        raise AssertionError(f"profiler recorded no device kernel "
                             f"matching {match!r}")
    return sum(times) / reps / 1e3, len(times) / reps


def kernel_ms(fn, reps: int = 20, match: str = "") -> float:
    return device_profile(fn, reps, match)[0]


def host_calls_ms(fn, reps: int = 100) -> float:
    """Host wall time of `reps` back-to-back calls and one
    torch.cuda.synchronize() after the last: launch overheads included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_close(out, ref, dtype, what: str, tol: float = None) -> float:
    """max|out - ref| <= tol * max(1, max|ref|), tol by default 5e-6 at
    f32 and 1e-12 at f64."""
    import torch
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    if tol is None:
        tol = 5e-6 if dtype == torch.float32 else 1e-12
    tol = tol * scale
    if not err <= tol:
        raise AssertionError(f"{what}: max|err| {err:.3e} > tol {tol:.3e}")
    return err


def phase_device():
    import torch
    from esoo_torch.native import native_available
    from esoo_torch.ops import _build
    card = nvidia_smi()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        eri_native = pool.submit(native_available)
        built = _build.build_all()
        native = eri_native.result()
    build_s = time.perf_counter() - t0
    emit("device", nvidia_smi=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, kernels_built=built,
         eri_engine="native" if native else "python",
         build_s=round(build_s, 3))
    return card


def _partial_unitary(m, n, dtype, gen):
    import torch
    q, _ = torch.linalg.qr(torch.randn(m, n, dtype=torch.float64,
                                       generator=gen))
    return q.to(dtype).contiguous()


def phase_kernels(card: str) -> dict:
    """Hold each kernel against its plain version; time both."""
    import torch
    from esoo_torch.ops import gemm
    dev = torch.device("cuda")
    bw, fl32 = peaks(card)
    gen = torch.Generator().manual_seed(0)
    checks = []
    m, n = 56, 4
    stage_shapes = [(m ** 3, m, n), (m * m * n, m, n), (m * n * n, m, n),
                    (n ** 3, m, n)]
    for dtype in (torch.float32, torch.float64):
        cases = [((300, 700, 150), tr) for tr in (False, True)] + \
                [((17, 33, 5), tr) for tr in (False, True)] + \
                [(s, True) for s in stage_shapes + NARROW_SHAPES]
        for (M, K, N), tr in cases:
            x = torch.randn((K, M) if tr else (M, K), dtype=torch.float64,
                            generator=gen).to(dtype).to(dev)
            y = torch.randn(K, N, dtype=torch.float64,
                            generator=gen).to(dtype).to(dev)
            out = gemm.matmul(x, y, trans_x=tr)
            again = gemm.matmul(x, y, trans_x=tr)
            torch.cuda.synchronize()
            err = check_close(out, gemm.matmul_plain(x, y, trans_x=tr),
                              dtype, f"matmul {M}x{K}x{N} trans_x={tr}")
            same = bool(torch.equal(out, again))
            if tr and N <= 16 and not same:       # the narrow kernel
                raise AssertionError(f"two narrow matmul calls {M}x{K}x{N} "
                                     f"{dtype} differ")
            checks.append(dict(kernel="gemm.matmul", M=M, K=K, N=N,
                               trans_x=tr, dtype=str(dtype), err=err,
                               repeat_bit_identical=same))
        # the one-pass kernel (transform.cu) at the headline shape, n = 8,
        # odd m (element-wise copies) and more blocks than slabs; the
        # four-launch chain (gemm.cu) at n = 12
        for (mm, nn, route) in ((56, 4, "fused"), (24, 8, "fused"),
                                (9, 3, "fused"), (4, 2, "fused"),
                                (24, 12, "chain")):
            g = torch.randn(mm, mm, mm, mm, dtype=torch.float64,
                            generator=gen).to(dtype).to(dev)
            u = _partial_unitary(mm, nn, dtype, gen).to(dev)
            planned = gemm._transform_plan(mm, nn, g.element_size())[0]
            if planned != route:
                raise AssertionError(f"m={mm} n={nn} planned {planned}, "
                                     f"expected {route}")
            out = gemm.rotate_two_body_cuda(g, u)
            again = gemm.rotate_two_body_cuda(g, u)
            torch.cuda.synchronize()
            err = check_close(out, gemm.rotate_two_body_plain(g, u), dtype,
                              f"rotate_two_body_cuda m={mm} n={nn} {route}")
            if route == "fused" and not torch.equal(out, again):
                raise AssertionError(f"two fused calls at m={mm} n={nn} "
                                     f"{dtype} differ")
            checks.append(dict(kernel="gemm.rotate_two_body_cuda",
                               route=route, m=mm, n=nn, dtype=str(dtype),
                               err=err, repeat_bit_identical=bool(
                                   torch.equal(out, again))))

    # timings at the main path's shapes, float32
    f32 = torch.float32
    x = torch.randn(m, m ** 3, dtype=torch.float64,
                    generator=gen).to(f32).to(dev)       # stage 1, (K, M)
    u = _partial_unitary(m, n, f32, gen).to(dev)
    g = x.reshape(m, m, m, m)
    M1, K1, N1 = m ** 3, m, n
    def k1_call():
        return gemm.matmul(x, u, trans_x=True)

    def k1_plain():
        return gemm.matmul_plain(x, u, trans_x=True)

    def k1_library():
        return torch.matmul(x.T, u)

    def k2_call():
        return gemm.rotate_two_body_cuda(g, u)

    def k2_plain():
        return gemm.rotate_two_body_plain(g, u)

    def k2_chain():
        return gemm.rotate_two_body_chain(g, u)

    def k2_library():
        t = torch.tensordot(g, u, dims=([0], [0]))
        t = torch.tensordot(t, u, dims=([0], [0]))
        t = torch.tensordot(t, u, dims=([0], [0]))
        return torch.tensordot(t, u, dims=([0], [0]))

    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    evict = torch.ones(32 * 2 ** 20, dtype=torch.float32, device=dev)

    # *_cold: the operand is evicted from the 50 MB L2 first, so the
    # kernel reads it from HBM; the warm numbers re-read an L2-resident
    # operand, as the main path does (the BB loop has just read g_sp).
    # The fill writes 128 MB and leaves L2 full of dirty lines, whose
    # write-back shares HBM with the kernel's reads; *_read_evicted
    # evicts by reading 128 MB instead (clean lines, no write-back).
    def k1_cold():
        flush.zero_()
        return gemm.matmul(x, u, trans_x=True)

    def k2_cold():
        flush.zero_()
        return gemm.rotate_two_body_cuda(g, u)

    def k2_chain_cold():
        flush.zero_()
        return gemm.rotate_two_body_chain(g, u)

    def k2_read_evicted():
        evict.sum()
        return gemm.rotate_two_body_cuda(g, u)

    def k2_chain_read_evicted():
        evict.sum()
        return gemm.rotate_two_body_chain(g, u)

    k1 = dict(ms=time_ms(k1_call), plain_ms=time_ms(k1_plain),
              library_ms=time_ms(k1_library),
              kernel_ms=kernel_ms(k1_call, match="gemm_"),
              kernel_ms_l2_flushed=kernel_ms(k1_cold, match="gemm_"),
              plain_kernel_ms=kernel_ms(k1_plain),
              max_abs_err=float((k1_call() - k1_library()).abs().max()))
    k1_bytes = 4 * (K1 * M1 + K1 * N1 + M1 * N1)
    k1_flops = 2 * M1 * K1 * N1
    # K2: the one-pass kernel (two launches, both named transform_*)
    # beside the four-launch chain (gemm_*) in the same run
    fused_kernel_ms, fused_events = device_profile(k2_call,
                                                   match="transform_")
    k2 = dict(ms=time_ms(k2_call), plain_ms=time_ms(k2_plain),
              library_ms=time_ms(k2_library),
              kernel_ms=fused_kernel_ms, kernel_launches_per_call=fused_events,
              pass_kernel_ms=kernel_ms(k2_call, match="transform_slab_pass"),
              reduce_kernel_ms=kernel_ms(k2_call, match="transform_reduce"),
              kernel_ms_l2_flushed=kernel_ms(k2_cold, match="transform_"),
              kernel_ms_read_evicted=kernel_ms(k2_read_evicted,
                                               match="transform_"),
              plain_kernel_ms=kernel_ms(k2_plain),
              chain_ms=time_ms(k2_chain),
              chain_kernel_ms=kernel_ms(k2_chain, match="gemm_"),
              chain_kernel_ms_l2_flushed=kernel_ms(k2_chain_cold,
                                                   match="gemm_"),
              chain_kernel_ms_read_evicted=kernel_ms(k2_chain_read_evicted,
                                                     match="gemm_"),
              host_100_calls_ms=host_calls_ms(k2_call),
              chain_host_100_calls_ms=host_calls_ms(k2_chain),
              max_abs_err=float((k2_call() - k2_library()).abs().max()))
    k2_bytes = 4 * (m ** 4 + m * n + n ** 4)
    # the one-pass kernel's FMAs: per slab m^2 n (T') and n^2 m (Y), per p
    # n^3 m (V) and n^4 (the accumulators)
    k2_flops = 2 * (m * m * (m * m * n + m * n * n)
                    + m * (m * n ** 3 + n ** 4))
    # K1 stage 1 and the transform's chain route at the CASSCF shapes,
    # (m, n) = (112, 14) and (112, 16), where they run on main paths.
    # The chain's own traffic (each stage's input read and output written)
    # is kept beside the function's, counted for bound_ms (g in, g_rot out).
    at_casscf = {nh: _kernels_at_casscf_shape(checks, nh, (bw, fl32))
                 for nh in (14, 16)}
    k1_sweep = _k1_stage1_sweep(checks, (bw, fl32))
    mh = 112
    Mh = mh ** 3
    bounded = [(k1, k1_bytes, k1_flops), (k2, k2_bytes, k2_flops)]
    for nh, (k1_h8, chain_h8) in at_casscf.items():
        chain_traffic = 4 * sum(mh * r + mh * nh + r * nh
                                for r in (mh ** 3, mh * mh * nh, mh * nh * nh,
                                          nh ** 3))
        chain_h8["chain_traffic_bytes"] = chain_traffic
        chain_h8["chain_traffic_bound_ms"] = chain_traffic / bw * 1e3
        bounded += [(k1_h8, 4 * (mh * Mh + mh * nh + Mh * nh),
                     2 * Mh * mh * nh),
                    (chain_h8, 4 * (mh ** 4 + mh * nh + nh ** 4),
                     2 * (mh ** 4 * nh + mh ** 3 * nh ** 2 + mh ** 2 * nh ** 3
                          + mh * nh ** 4))]
    for rec, nbytes, flops in bounded:
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fl32 * 1e3
        rec.update(bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
    (k1_h8, chain_h8), (k1_h8_16, chain_h8_16) = at_casscf[14], at_casscf[16]
    emit("kernels", kernels=["gemm.matmul", "gemm.rotate_two_body_cuda"],
         checks=checks, tolerance="f32 atol 5e-6*max(1,max|ref|); "
         "f64 1e-12*max(1,max|ref|)", peak_bytes_per_s=bw,
         peak_f32_flops=fl32, matmul=k1, rotate_two_body_cuda=k2,
         matmul_casscf_stage1=k1_h8, rotate_two_body_chain_casscf=chain_h8,
         matmul_casscf_stage1_n16=k1_h8_16,
         rotate_two_body_chain_casscf_n16=chain_h8_16,
         matmul_stage1_m112_sweep=k1_sweep,
         timing=f"ms: median over 50 calls after 5 warm-up of CUDA events "
         f"around each call, the calls queued behind a device spin (no host "
         f"launch gaps); kernel_ms: profiler kernel time per call; "
         f"host_100_calls_ms: host wall of 100 calls and one sync; {card}")
    return {"gemm.matmul": dict(k1_h8, shape="m=112 n=14 stage 1 "
                                "(1404928x112)^T @ (112x14)",
                                at_h4_stage1=k1, at_m112_n16=k1_h8_16,
                                stage1_m112_sweep=k1_sweep),
            "gemm.rotate_two_body_cuda": dict(
                k2, shape="m=56 n=4 one-pass kernel",
                chain_at_m112_n14=chain_h8, chain_at_m112_n16=chain_h8_16)}


def _k1_bounded(rec: dict, K: int, M: int, N: int, peak: tuple) -> dict:
    """rec with the bound of x^T y, x (K, M), y (K, N), float32: the larger
    of the bytes of x and y read once and of out written once at the
    memory rate, and the 2 K M N FLOPs at the float32 CUDA-core rate."""
    bw, fl32 = peak
    nbytes, flops = 4 * (K * M + K * N + M * N), 2 * K * M * N
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl32 * 1e3
    rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    rec["pct_of_bound"] = 100 * rec["bound_ms"] / rec["kernel_ms"]
    return rec


def _k1_stage1_sweep(checks: list, peak: tuple) -> list:
    """K1 at stage 1 of the transform at m=112 (x (112, 112^3), float32)
    for each n of K1_SWEEP_N: held against its plain version, its kernel
    time beside its bound and torch.matmul(x.T, u)'s."""
    import torch
    from esoo_torch.ops import gemm
    dev, f32, m = torch.device("cuda"), torch.float32, 112
    x = torch.randn(m, m ** 3, dtype=f32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    recs = []
    for n in K1_SWEEP_N:
        u = _partial_unitary(m, n, f32,
                             torch.Generator().manual_seed(n)).to(dev)
        out = gemm.matmul(x, u, trans_x=True)
        torch.cuda.synchronize()
        err = check_close(out, gemm.matmul_plain(x, u, trans_x=True), f32,
                          f"gemm.matmul m=112 n={n} stage 1")
        checks.append(dict(kernel="gemm.matmul", M=m ** 3, K=m, N=n,
                           trans_x=True, dtype=str(f32), err=err,
                           shape="stage 1 sweep"))
        def call():
            return gemm.matmul(x, u, trans_x=True)

        def library():
            return torch.matmul(x.T, u)

        recs.append(_k1_bounded(dict(
            n=n, kernel_ms=kernel_ms(call, match="gemm_"), ms=time_ms(call),
            library_ms=time_ms(library), library_kernel_ms=kernel_ms(library),
            max_abs_err=err), m, m ** 3, n, peak))
    return recs


def _kernels_at_casscf_shape(checks: list, n: int, peak: tuple):
    """K1 stage 1 and the transform's chain route at a CASSCF path's
    shape (m=112, n=14 at N=28 or 16 at N=32, float32), held against
    their plain versions and timed; the chain's four K1 stages also one
    by one, each on its own input from the chain.  The 629 MB g does not
    fit the 50 MB L2, so every call reads it from HBM and no flush is
    needed."""
    import torch
    from esoo_torch.ops import gemm
    dev, f32 = torch.device("cuda"), torch.float32
    m = 112
    if gemm._transform_plan(m, n, 4)[0] != "chain":
        raise AssertionError(f"m=112 n={n} should take the chain route")
    dgen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((m,) * 4, dtype=f32, device=dev, generator=dgen)
    u = _partial_unitary(m, n, f32, torch.Generator().manual_seed(2)).to(dev)
    x = g.reshape(m, m ** 3)
    out = gemm.rotate_two_body_cuda(g, u)
    stage = gemm.matmul(x, u, trans_x=True)
    torch.cuda.synchronize()
    for kernel, got, ref in (
            ("gemm.rotate_two_body_cuda", out,
             gemm.rotate_two_body_plain(g, u)),
            ("gemm.matmul", stage, gemm.matmul_plain(x, u, trans_x=True))):
        err = check_close(got, ref, f32, f"{kernel} m={m} n={n} (casscf)")
        checks.append(dict(kernel=kernel, route="chain", m=m, n=n,
                           dtype=str(f32), err=err, shape="casscf"))

    def k1_call():
        return gemm.matmul(x, u, trans_x=True)

    def k1_plain():
        return gemm.matmul_plain(x, u, trans_x=True)

    def chain_call():
        return gemm.rotate_two_body_cuda(g, u)

    def chain_plain():
        return gemm.rotate_two_body_plain(g, u)

    def chain_library():
        t = torch.tensordot(g, u, dims=([0], [0]))
        t = torch.tensordot(t, u, dims=([0], [0]))
        t = torch.tensordot(t, u, dims=([0], [0]))
        return torch.tensordot(t, u, dims=([0], [0]))

    chain_kernel_ms, chain_events = device_profile(chain_call, match="gemm_")
    k1 = dict(ms=time_ms(k1_call), plain_ms=time_ms(k1_plain),
              library_ms=time_ms(lambda: torch.matmul(x.T, u)),
              kernel_ms=kernel_ms(k1_call, match="gemm_"),
              plain_kernel_ms=kernel_ms(k1_plain),
              max_abs_err=float((k1_call() - torch.matmul(x.T, u))
                                .abs().max()))
    stages, t, rest = [], g, m ** 3
    for _ in range(4):
        xs = t.reshape(m, rest)
        t = gemm.matmul(xs, u, trans_x=True)
        def call(xs=xs):
            return gemm.matmul(xs, u, trans_x=True)

        def library(xs=xs):
            return torch.matmul(xs.T, u)

        stages.append(_k1_bounded(dict(
            M=rest, kernel_ms=kernel_ms(call, match="gemm_"),
            ms=time_ms(call), library_ms=time_ms(library),
            library_kernel_ms=kernel_ms(library)), m, rest, n, peak))
        rest = rest // m * n
    chain = dict(ms=time_ms(chain_call), plain_ms=time_ms(chain_plain),
                 library_ms=time_ms(chain_library),
                 kernel_ms=chain_kernel_ms,
                 kernel_launches_per_call=chain_events,
                 plain_kernel_ms=kernel_ms(chain_plain),
                 stages=stages,
                 max_abs_err=float((chain_call() - chain_library())
                                   .abs().max()))
    return k1, chain


def _solver(problem, n_act: int, dtype, device):
    import esoo_torch
    parts = problem.num_particles
    ansatz = esoo_torch.UCCSD(
        n_act, parts, initial_state=esoo_torch.HartreeFock(n_act, parts))
    return esoo_torch.FusedOptOrbVQE(
        num_spin_orbitals=2 * n_act, ansatz=ansatz, problem=problem,
        maxiter=20, stopping_tolerance=1e-5, dtype=dtype, device=device,
        diagnostics=False)


def phase_main_path():
    import torch
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.fused import _ORBITAL_VAG
    from esoo_torch.orbital_optimization.stiefel import (_bb_loop,
                                                         value_and_grad)

    t0 = time.perf_counter()
    problem = MoleculeDriver(atom=H4_GEOM, basis="cc-pvtz").run()
    chem_s = time.perf_counter() - t0
    assert problem.num_spatial_orbitals == 56, problem.num_spatial_orbitals

    gemm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = _solver(problem, 4, torch.float32, "cuda").compute_minimum_energy()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()

    t0 = time.perf_counter()
    r_warm = _solver(problem, 4, torch.float32,
                     "cuda").compute_minimum_energy()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    E = r.eigenvalue
    # at n = 4 the transform takes the one-pass route; K1 (gemm.matmul)
    # runs only in the chain route, held in the kernels phase
    if launches["gemm.rotate_two_body_cuda"] <= 0 or routes["fused"] <= 0:
        raise AssertionError(f"the one-pass transform never launched on the "
                             f"main path: {launches} {routes}")
    if not (E <= H4_BASELINE and abs(E - H4_REFERENCE) <= H4_TOL):
        raise AssertionError(f"H4 energy {E!r} fails the gates "
                             f"(<= {H4_BASELINE}, within {H4_TOL} of "
                             f"{H4_REFERENCE})")
    if not abs(r_warm.eigenvalue - E) <= H4_TOL:
        raise AssertionError("warm run disagrees with the cold run")

    # per-step costs at the final state: one BB iteration (value and grad
    # of the orbital energy + the Stiefel projection + the stop test) and
    # one L-BFGS evaluation (gate scan + sigma, forward and backward)
    solver = _solver(problem, 4, torch.float32, "cuda")
    h_sp, g_sp = solver._h_sp, solver._g_sp
    U = torch.as_tensor(r.optimal_partial_unitary, device="cuda")
    theta = torch.as_tensor(r.optimal_point, device="cuda")
    sec = solver._sector
    gamma_s, Gamma_s = K.spin_reduce_rdms(*sec.rdms(sec.state_matrix(theta)))
    data = (gamma_s, Gamma_s, h_sp, g_sp)
    h_so, g_so = K.expand_spin_tensors(K.rotate_one_body(h_sp, U),
                                       K.rotate_two_body(g_sp, U))
    vals = sec.build_values(h_so, g_so)
    sector_vag = value_and_grad(sec.energy_values)
    scalar = functools.partial(torch.tensor, dtype=torch.float32, device="cuda")
    bb_steps = 50
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _bb_loop(_ORBITAL_VAG, U, data, scalar(1e-3), scalar(1e-30),
             scalar(0.8), bb_steps)
    torch.cuda.synchronize()
    bb_wall_ms = (time.perf_counter() - t0) / bb_steps * 1e3

    def lbfgs_eval():
        return sector_vag(theta, vals)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        lbfgs_eval()
    torch.cuda.synchronize()
    lbfgs_wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    vag_ms, vag_events = device_profile(lambda: _ORBITAL_VAG(U, *data))
    eval_ms, eval_events = device_profile(lbfgs_eval)
    per_iter = dict(
        bb_iteration_wall_ms=bb_wall_ms,
        orbital_value_and_grad_kernel_ms=vag_ms,
        orbital_value_and_grad_device_events=vag_events,
        kron_sandwich_kernel_ms=kernel_ms(
            lambda: K.rotate_two_body_kron(g_sp, U)),
        lbfgs_evaluation_wall_ms=lbfgs_wall_ms,
        lbfgs_evaluation_kernel_ms=eval_ms,
        lbfgs_evaluation_device_events=eval_events)
    stats = r_warm.stage_stats
    emit("main_path", problem="H4 cc-pVTZ m=56 -> 8 spin orbitals, UCCSD "
         "(26 parameters), f32", energy=E, energy_warm=r_warm.eigenvalue,
         energy_gates=[H4_BASELINE, H4_REFERENCE, H4_TOL],
         outer_iterations=r.outer_iterations, warm_stage_stats=stats,
         chem_s=chem_s, cold_s=cold_s, warm_s=warm_s,
         eri_engine=problem.eri_engine, launches=launches,
         transform_route_launches=routes, per_step=per_iter)
    return launches, problem


def phase_profile(problem) -> None:
    """Device busy share and time by kernel over one warm main-path run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _solver(problem, 4, torch.float32, "cuda").compute_minimum_energy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for name, us in _device_events(prof):
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, cnt + 1)
    rows = sorted(((tot, name, cnt) for name, (tot, cnt) in by_name.items()),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    emit("profile", wall_s=wall, device_busy_s=busy_us / 1e6,
         device_busy_share=busy_us / 1e6 / wall,
         device_events=sum(r[2] for r in rows),
         top_kernels=[dict(name=k[:90], device_ms=d / 1e3, count=c)
                      for d, k, c in rows[:15]])


def _casscf_solver(problem, n_act: int, dtype, device, **kw):
    import esoo_torch
    return esoo_torch.FusedOptOrbCASSCF(
        num_spin_orbitals=2 * n_act, problem=problem, dtype=dtype,
        device=device, **kw)


def phase_casscf() -> dict:
    """FusedOptOrbCASSCF on H8 cc-pVTZ (m=112 -> 28 spin orbitals), f32,
    dense tables, maxiter 10, tol 1e-5: the configuration of the JAX
    package's bench (bench.py:491-494).  One solve; the per-step costs are
    taken at its final state."""
    import torch
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.casscf import _sector_ci_cached
    from esoo_torch.orbital_optimization.fused import _ORBITAL_VAG
    from esoo_torch.orbital_optimization.stiefel import _bb_loop

    f32, dev = torch.float32, "cuda"
    t0 = time.perf_counter()
    problem = MoleculeDriver(atom=H8_GEOM, basis="cc-pvtz").run()
    chem_s = time.perf_counter() - t0
    if problem.num_spatial_orbitals != 112:
        raise AssertionError(f"H8 cc-pVTZ gave m="
                             f"{problem.num_spatial_orbitals}, expected 112")
    t0 = time.perf_counter()
    sector = _sector_ci_cached(28, problem.num_particles)
    sector_s = time.perf_counter() - t0
    if sector.dim != 1_002_001:
        raise AssertionError(f"sector dimension {sector.dim}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = _casscf_solver(problem, 14, f32, dev, maxiter=10,
                            stopping_tolerance=1e-5, dispatch="two")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0          # integrals and tables sent

    torch.cuda.reset_peak_memory_stats()
    gemm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solver.compute_minimum_energy()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()

    E, trace, stats = r.eigenvalue, r.energy_convergence_list, r.stage_stats

    # per-step costs at the final state: one sigma (the Davidson matvec),
    # the sigma operators and the diagonal (once per solve), one RDM
    # extraction, one orbital value and grad, and one BB iteration (value
    # and grad, the projection and the stop test)
    sec, tabs = solver._sector, solver._sector_tables
    U = torch.as_tensor(r.optimal_partial_unitary, device=dev)
    V = torch.as_tensor(r.optimal_point, device=dev).reshape(sec.nB, sec.nA)
    h_so, g_so = K.expand_spin_tensors(
        K.rotate_one_body(solver._h_sp, U), K.rotate_two_body(solver._g_sp, U))
    vals = sec.build_values(h_so, g_so, tabs)
    gamma_s, Gamma_s = K.spin_reduce_rdms(*sec.rdms(V, tabs))
    data = (gamma_s, Gamma_s, solver._h_sp, solver._g_sp)
    scalar = functools.partial(torch.tensor, dtype=f32, device=dev)

    def bb(steps):
        return _bb_loop(_ORBITAL_VAG, U, data, scalar(1e-3), scalar(1e-30),
                        scalar(0.8), steps)

    # one BB iteration: the difference of an 11- and a 1-step loop, over 10
    steps = {"sigma": (lambda: sec.sigma_values(V, vals, tabs), 1),
             "build_values": (lambda: sec.build_values(h_so, g_so, tabs), 1),
             "diagonal": (lambda: sec.diagonal_values(vals, tabs), 1),
             "rdms": (lambda: sec.rdms(V, tabs), 1),
             "orbital_value_and_grad": (lambda: _ORBITAL_VAG(U, *data), 1),
             "bb_iteration": (lambda: bb(11), 10)}
    per_step = {}
    for name, (fn, per) in steps.items():
        base = (lambda: bb(1)) if name == "bb_iteration" else (lambda: None)
        times = []
        for f in (fn, base):
            f()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                f()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / 3 * 1e3)
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - before
        dev_ms, events = device_profile(fn, reps=3)
        if name == "bb_iteration":
            dev_base, ev_base = device_profile(base, reps=3)
            dev_ms, events = dev_ms - dev_base, events - ev_base
        per_step[name] = dict(wall_ms=(times[0] - times[1]) / per,
                              device_ms=dev_ms / per,
                              device_events=events / per,
                              peak_extra_bytes=extra)
    diag_abs_max = float(sec.diagonal_values(vals, tabs).abs().max())
    witness = _casscf_f64_witness(problem, solver, r, vals)

    failed = []
    if not abs(E - H8_CASSCF_REFERENCE) <= H8_CASSCF_TOL:
        failed.append(f"energy {E!r} not within {H8_CASSCF_TOL} of "
                      f"{H8_CASSCF_REFERENCE}")
    failed += _casscf_gates(r, witness, launches, routes)
    emit("casscf", problem="H8 cc-pVTZ m=112 -> 28 spin orbitals, (4, 4) "
         "electrons, 1,002,001 determinants, f32, dense tables, maxiter 10",
         energy=E, energy_gates=[H8_CASSCF_REFERENCE, H8_CASSCF_TOL,
                                 H8_F64_WITNESS_TOL],
         outer_trace=trace, outer_iterations=r.outer_iterations,
         stage_stats=stats, chem_s=chem_s, sector_ci_s=sector_s,
         setup_s=setup_s, solve_s=solve_s, eri_engine=problem.eri_engine,
         peak_memory_bytes=peak_bytes, launches=launches,
         transform_route_launches=routes, per_step=per_step,
         diag_abs_max=diag_abs_max, f64_witness=witness,
         gates_failed=failed)
    if failed:
        raise AssertionError("H8 CASSCF gates failed: " + "; ".join(failed))
    return launches, problem


def _casscf_gates(r, witness: dict, launches: dict, routes: dict) -> list:
    """The gates every H8 CASSCF solve meets beside its energy window."""
    E, trace, stats = r.eigenvalue, r.energy_convergence_list, r.stage_stats
    rotations = stats["davidson_solves"]     # one rotation before each solve
    failed = []
    if not E <= trace[0]:
        failed.append(f"energy {E!r} above the first outer energy "
                      f"{trace[0]!r}")
    # The float32 Davidson stalls above its 1e-6 * max(1, |E|) rule at
    # nd = 1M: warm solves end by the stagnation exit at residuals of
    # 2-4e-5, and warm solves restarted from the final vector leave it as
    # it is, though sigma's own float32 error there is ~40x smaller (the
    # float64 witness; PERF.md section 6).  So the final solve must end by
    # one of the solver's own rules, not by maxiter, with its residual
    # within 10x the rule, and the float64 ground energy at the final
    # orbitals must agree with E.
    rn_final = stats["davidson_residuals"][-1]
    if (stats["davidson_exits"][-1] == "maxiter"
            or not rn_final <= 10 * 1e-6 * max(1.0, abs(E))):
        failed.append(f"the final Davidson solve ended by "
                      f"{stats['davidson_exits'][-1]} with residual "
                      f"{rn_final!r} (limit 1e-5 * max(1, |E|))")
    if not abs(witness["energy_f64"] - E) <= H8_F64_WITNESS_TOL:
        failed.append(f"the float64 energy at the final orbitals "
                      f"{witness['energy_f64']!r} differs from {E!r} by "
                      f"more than {H8_F64_WITNESS_TOL}")
    # n > 8: every rotation is the transform's four-launch K1 chain
    if not (rotations == r.outer_iterations + 1
            and launches["gemm.matmul"] == 4 * rotations
            and launches["gemm.rotate_two_body_cuda"] == 4 * rotations
            and routes == {"fused": 0, "chain": 4 * rotations}):
        failed.append(f"{rotations} rotations but launches {launches}, "
                      f"routes {routes}")
    return failed


def event_ms(fn, reps: int = 3) -> float:
    """Median over `reps` calls, after one warm-up, of CUDA events recorded
    just before and just after each call, host launch gaps included.  For
    calls of thousands of launches, which fill the launch queue: time_ms
    cannot queue them behind a device spin."""
    import torch
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)[reps // 2]


def _op_costs(fn, reps: int = 3) -> dict:
    """One call's cost: `ms` (event_ms), device time and events per call
    (profiler), and the peak memory the call adds to what is allocated
    before it."""
    import torch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    dev_ms, events = device_profile(fn, reps=max(1, reps - 1))
    return dict(ms=event_ms(fn, reps), device_ms=dev_ms,
                device_events=events, peak_extra_bytes=extra)


def _storage_pair(sector, h_sp, g_sp, U, gen, dev) -> dict:
    """The compact and dense sigma operators, sigma, RDMs and diagonal at
    the integrals rotated by U, on one seeded unit vector, held against
    each other (COMPACT_TOL) and costed per storage."""
    import torch
    from esoo_torch.orbital_optimization import kernels as K
    f32 = torch.float32
    h_so, g_so = K.expand_spin_tensors(K.rotate_one_body(h_sp, U),
                                       K.rotate_two_body(g_sp, U))
    V = torch.randn((sector.nB, sector.nA), dtype=f32, device=dev,
                    generator=gen)
    V = V / torch.linalg.norm(V)
    out, costs = {}, {}
    for storage in ("dense", "compact"):
        tabs = sector.device_tables(f32, device=dev, storage=storage)
        vals = sector.build_values(h_so, g_so, tabs)
        ops = {"build_values": lambda: sector.build_values(h_so, g_so, tabs),
               "sigma": lambda: sector.sigma_values(V, vals, tabs),
               "rdms": lambda: sector.rdms(V, tabs),
               "diagonal": lambda: sector.diagonal_values(vals, tabs)}
        out[storage] = dict(
            FA=vals["FA"], FB=vals["FB"], sigma=ops["sigma"](),
            diagonal=ops["diagonal"](), **dict(zip(("gamma", "Gamma"),
                                                  ops["rdms"]())))
        costs[storage] = {name: _op_costs(fn) for name, fn in ops.items()}
        del tabs, vals, ops
    errs = {k: check_close(out["compact"][k], out["dense"][k], f32,
                           f"compact vs dense {k}", tol=COMPACT_TOL)
            for k in out["dense"]}
    return dict(max_abs_err=errs, costs=costs)


def _drop_tables(sector, storage: str) -> None:
    """Free a sector's cached device tables of one storage."""
    import torch
    for key in [k for k in sector._dev_tabs if k[-1] == storage]:
        del sector._dev_tabs[key]
    torch.cuda.empty_cache()


def phase_compact(problem) -> dict:
    """FusedOptOrbCASSCF on H8 cc-pVTZ (m=112 -> 32 spin orbitals,
    3,312,400 determinants), f32, maxiter 10, tol 1e-5, dispatch='two',
    the default table_storage='auto': the JAX package's compact flagship
    (bench.py:491-494 at n_red_so=32).  Before the solve, the two storages
    on one vector at N=32 and sigma at N=28."""
    import esoo_torch
    import torch
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.casscf import _sector_ci_cached
    f32, dev = torch.float32, torch.device("cuda")
    parts = problem.num_particles
    t0 = time.perf_counter()
    sector = _sector_ci_cached(32, parts)
    sector_s = time.perf_counter() - t0
    if (sector.nA, sector.nB, sector.dim) != (1820, 1820, 3_312_400):
        raise AssertionError(f"N=32 sector {sector.nB} x {sector.nA}")
    transfer_s = {}
    for storage in ("compact", "dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sector.device_tables(f32, device=dev, storage=storage)
        torch.cuda.synchronize()
        transfer_s[storage] = time.perf_counter() - t0

    h_np, g_np = problem.spatial_integral_tensors()
    h_sp = torch.as_tensor(h_np, device=dev).to(f32)
    g_sp = torch.as_tensor(g_np, device=dev).to(f32).contiguous()
    gen = torch.Generator(device=dev).manual_seed(32)
    U = _partial_unitary(112, 16, f32, torch.Generator().manual_seed(32))
    at_n32 = _storage_pair(sector, h_sp, g_sp, U.to(dev), gen, dev)
    _drop_tables(sector, "dense")

    # one sigma at N=28 in both storages
    s28 = _sector_ci_cached(28, parts)
    U28 = _partial_unitary(112, 14, f32, torch.Generator().manual_seed(28))
    h_so, g_so = K.expand_spin_tensors(K.rotate_one_body(h_sp, U28.to(dev)),
                                       K.rotate_two_body(g_sp, U28.to(dev)))
    V28 = torch.randn((s28.nB, s28.nA), dtype=f32, device=dev, generator=gen)
    V28 = V28 / torch.linalg.norm(V28)
    sig28, cost28 = {}, {}
    for storage in ("dense", "compact"):
        tabs = s28.device_tables(f32, device=dev, storage=storage)
        vals = s28.build_values(h_so, g_so, tabs)
        sig28[storage] = s28.sigma_values(V28, vals, tabs)
        cost28[storage] = _op_costs(
            lambda: s28.sigma_values(V28, vals, tabs))
        del tabs, vals
    err28 = check_close(sig28["compact"], sig28["dense"], f32,
                        "compact vs dense sigma at N=28", tol=COMPACT_TOL)
    del sig28, h_so, g_so, h_sp, g_sp
    for storage in ("dense", "compact"):
        _drop_tables(s28, storage)

    solver = esoo_torch.FusedOptOrbCASSCF(
        num_spin_orbitals=32, problem=problem, maxiter=10,
        stopping_tolerance=1e-5, dtype=f32, dispatch="two")
    if solver.table_storage != "compact":
        raise AssertionError(f"table_storage='auto' resolved to "
                             f"{solver.table_storage!r} at N=32")
    torch.cuda.reset_peak_memory_stats()
    gemm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solver.compute_minimum_energy()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()

    E = r.eigenvalue
    sec, tabs = solver._sector, solver._sector_tables
    U = torch.as_tensor(r.optimal_partial_unitary, device=dev)
    vals = sec.build_values(*K.expand_spin_tensors(
        K.rotate_one_body(solver._h_sp, U), K.rotate_two_body(solver._g_sp, U)),
        tabs)
    witness = _casscf_f64_witness(problem, solver, r, vals)
    failed = []
    lo, hi = H8_N32_WINDOW
    if not lo <= E <= hi:
        failed.append(f"energy {E!r} outside [{lo}, {hi}]")
    failed += _casscf_gates(r, witness, launches, routes)
    emit("compact", problem="H8 cc-pVTZ m=112 -> 32 spin orbitals, (4, 4) "
         "electrons, 3,312,400 determinants, f32, compact int8 tables "
         "(table_storage='auto'), maxiter 10", energy=E,
         energy_window=H8_N32_WINDOW, table_storage=solver.table_storage,
         outer_trace=r.energy_convergence_list,
         outer_iterations=r.outer_iterations, stage_stats=r.stage_stats,
         sector_ci_s=sector_s, tables_to_card_s=transfer_s, solve_s=solve_s,
         peak_memory_bytes=peak_bytes, launches=launches,
         transform_route_launches=routes, storages_n32=at_n32,
         storages_n28_sigma=dict(max_abs_err=err28, costs=cost28),
         tolerance=f"compact vs dense: max|err| <= {COMPACT_TOL} * max(1, "
         f"max|dense|)", timing="costs: ms, median of 3 CUDA-event pairs "
         "around each call (launch gaps included); device_ms and "
         "device_events per call, torch.profiler; peak_extra_bytes above "
         "what was allocated before the call", f64_witness=witness,
         gates_failed=failed)
    if failed:
        raise AssertionError("H8 N=32 CASSCF gates failed: "
                             + "; ".join(failed))
    return launches


def _ssvqe_h4(problem, dtype, device):
    import esoo_torch as T
    return T.FusedOptOrbSSVQE(
        num_spin_orbitals=8, ansatz=T.UCCSD(4, (2, 2)),
        initial_states=[T.HartreeFock(4, (2, 2)),
                        T.OccupationState(8, H4_EXCITED_MASK)],
        weight_vector=[2.0, 1.0], problem=problem, maxiter=20,
        stopping_tolerance=1e-5, dtype=dtype, device=device)


def _exact_sector_spectrum(problem, U, n: int, parts):
    """Eigenvalues of the sector Hamiltonian at the orbitals U, float64 on
    the host: SectorCI sigma on every unit vector, then eigvalsh."""
    import torch
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.sim import SectorCI
    f64 = torch.float64
    h, g = (torch.as_tensor(a).to(f64)
            for a in problem.spatial_integral_tensors())
    U = U.to(device="cpu", dtype=f64)
    ci = SectorCI(2 * n, parts)
    vals = ci.build_values(*K.expand_spin_tensors(K.rotate_one_body(h, U),
                                                  K.rotate_two_body(g, U)))
    H = torch.stack([ci.sigma_values(e.reshape(ci.nB, ci.nA), vals).reshape(-1)
                     for e in torch.eye(ci.dim, dtype=f64)], dim=1)
    return torch.linalg.eigvalsh((H + H.T) / 2).numpy()


def phase_excited(problem) -> dict:
    """FusedOptOrbSSVQE on H4 cc-pVTZ (m=56 -> 8), f32, cold and warm; the
    launch counts zeroed before the cold run and read after it.  Then the
    fused excited-state family on H2 6-31G at f64, card against CPU."""
    import esoo_torch as T
    import torch
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.stiefel import value_and_grad
    f32 = torch.float32
    gemm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = _ssvqe_h4(problem, f32, "cuda").compute_energies()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()
    t0 = time.perf_counter()
    solver = _ssvqe_h4(problem, f32, "cuda")
    r_warm = solver.compute_energies()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # one L-BFGS evaluation at the final state: the k = 2 states through
    # one batched gate scan, their energies, weighted, forward and backward
    sec, init, w = solver._sector, solver._init, solver._weights
    U = torch.as_tensor(r.optimal_partial_unitary, device="cuda")
    theta = torch.as_tensor(r.optimal_point, device="cuda")
    vals = sec.build_values(*K.expand_spin_tensors(
        K.rotate_one_body(solver._h_sp, U), K.rotate_two_body(solver._g_sp, U)))
    vag = value_and_grad(
        lambda th: w @ sec.quadform_values(sec.apply_matrix(init, th), vals))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        vag(theta)
    torch.cuda.synchronize()
    eval_wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    eval_ms, eval_events = device_profile(lambda: vag(theta))
    lam = _exact_sector_spectrum(problem, U, 4, (2, 2))

    E = [float(e) for e in r.eigenvalues]
    failed = []
    if not all(abs(e - ref) <= H4_SSVQE_TOL
               for e, ref in zip(E, H4_SSVQE_F64)):
        failed.append(f"energies {E} not within {H4_SSVQE_TOL} of the JAX "
                      f"package's float64 {H4_SSVQE_F64}")
    if not (E[0] >= lam[0] - 1e-6
            and 2 * E[0] + E[1] >= 2 * lam[0] + lam[1] - 1e-5):
        failed.append(f"energies {E} below the exact sector spectrum "
                      f"{lam[:2].tolist()} (weights 2, 1)")
    if not (launches["gemm.rotate_two_body_cuda"] > 0
            and launches["gemm.matmul"] == 0 and routes["chain"] == 0):
        failed.append(f"launches {launches}, routes {routes}: the one-pass "
                      f"transform only, no K1")
    if not all(abs(a - b) <= H4_SSVQE_TOL
               for a, b in zip(r_warm.eigenvalues, E)):
        failed.append("the warm run disagrees with the cold run")
    emit("excited", problem="H4 cc-pVTZ m=56 -> 8 spin orbitals, "
         "FusedOptOrbSSVQE, UCCSD (26 parameters), HF and HOMO->LUMO alpha "
         "single, weights [2, 1], f32", energies=E,
         energies_warm=[float(e) for e in r_warm.eigenvalues],
         jax_f64=H4_SSVQE_F64, tolerance=H4_SSVQE_TOL,
         exact_sector_spectrum=lam[:4].tolist(),
         outer_iterations=r.outer_iterations,
         outer_trace=r.energy_convergence_list, stage_stats=r.stage_stats,
         warm_stage_stats=r_warm.stage_stats, cold_s=cold_s, warm_s=warm_s,
         lbfgs_evaluation_wall_ms=eval_wall_ms,
         lbfgs_evaluation_device_ms=eval_ms,
         lbfgs_evaluation_device_events=eval_events, launches=launches,
         transform_route_launches=routes, gates_failed=failed)
    if failed:
        raise AssertionError("H4 SSVQE gates failed: " + "; ".join(failed))

    from esoo_torch.chem import MoleculeDriver
    h2 = MoleculeDriver(atom=H2_GEOM, basis="6-31g").run()
    f64, hf = torch.float64, T.HartreeFock(2, (1, 1))
    inits = [hf, T.OccupationState(4, 0b0110)]
    makers = {
        "ssvqe": lambda d: T.FusedOptOrbSSVQE(
            4, T.UCCSD(2, (1, 1), reps=2), initial_states=inits,
            weight_vector=[2, 1], problem=h2, maxiter=20, dtype=f64,
            device=d).compute_energies().eigenvalues,
        "mcvqe": lambda d: T.FusedOptOrbMCVQE(
            4, T.UCCSD(2, (1, 1), reps=2), num_particles=(1, 1), k=2,
            excitations="s", weight_vector=[2, 1], problem=h2, maxiter=20,
            dtype=f64, device=d).compute_energies().eigenvalues,
        "vqd": lambda d: T.FusedOptOrbVQD(
            4, T.UCCSD(2, (1, 1), reps=2), initial_states=inits,
            betas=[2.0], weight_vector=[2, 1], problem=h2, maxiter=20,
            dtype=f64, device=d).compute_energies().eigenvalues,
        "adapt": lambda d: [T.FusedOptOrbAdaptVQE(
            4, T.UCCSD(2, (1, 1), initial_state=hf), problem=h2, maxiter=20,
            dtype=f64, device=d).compute_minimum_energy().eigenvalue]}
    runs, failed = {}, []
    for name, make in makers.items():
        gemm.reset_launch_counts()
        card_e = [float(e) for e in make("cuda")]
        fused = gemm.route_launch_counts()["fused"]
        cpu_e = [float(e) for e in make("cpu")]
        runs[name] = dict(card=card_e, cpu=cpu_e, transform_launches=fused)
        if not (max(abs(a - b) for a, b in zip(card_e, cpu_e)) <= 1e-8
                and all(abs(a - b) <= H2_ANCHOR_TOL for a, b in
                        zip(card_e, H2_EXCITED_ANCHORS[name])) and fused > 0):
            failed.append(f"{name}: card {card_e}, CPU {cpu_e}, anchors "
                          f"{H2_EXCITED_ANCHORS[name]}, {fused} launches")
    emit("excited_parity", problem="H2 6-31G -> 4 spin orbitals, f64",
         runs=runs, tolerance=[1e-8, H2_ANCHOR_TOL], gates_failed=failed)
    if failed:
        raise AssertionError("H2 excited-state parity failed: "
                             + "; ".join(failed))
    return launches


def _casscf_f64_witness(problem, solver, r, vals32) -> dict:
    """What the float32 solve's final state is worth, held against float64
    on the card at the final orbitals U:

      sigma_f32_err     ||sigma_f32(x) - sigma_f64(x)|| at the final unit
                        vector x, the same float32 operators cast up: the
                        float32 arithmetic of sigma alone;
      residual_f64      ||H x - (x.H x) x|| with H built in float64 from the
                        float64 integrals at U: x's true residual (and
                        energy_f64_of_x, x.H x);
      restarts          the float32 residual after each of up to 3 warm
                        float32 Davidson solves chained from x (each appends
                        at least one correction), and the float64 residual
                        of the last vector;
      ritz_step         one Rayleigh-Ritz step over [x, t], t the solver's
                        correction, its 2x2 projection formed in float32
                        and in float64 arithmetic from the same float32
                        vectors and images; each step's residual evaluated
                        in float64;
      energy_f64        the float64 Davidson ground energy at U (tol 1e-9).

    The float64 operators take the plain transform (no kernel launch) and
    the solver's table storage."""
    import torch
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.solvers import davidson_ground
    from esoo_torch.solvers.davidson import _guard
    f64, dev = torch.float64, solver.device
    sec, tabs32 = solver._sector, solver._sector_tables
    nB, nA = sec.nB, sec.nA
    tabs64 = sec.device_tables(f64, device=dev, storage=solver.table_storage)
    x32 = torch.as_tensor(r.optimal_point, device=dev).reshape(nB, nA)
    x32 = x32 / torch.linalg.norm(x32)
    up = {k: v.double() for k, v in vals32.items()}
    sigma_err = float(torch.linalg.norm(
        sec.sigma_values(x32, vals32, tabs32).double()
        - sec.sigma_values(x32.double(), up, tabs64)))

    h_np, g_np = problem.spatial_integral_tensors()
    U = torch.as_tensor(r.optimal_partial_unitary, device=dev).double()
    h_so, g_so = K.expand_spin_tensors(
        K.rotate_one_body(torch.as_tensor(h_np, device=dev), U),
        gemm.rotate_two_body_plain(
            torch.as_tensor(g_np, device=dev).contiguous(), U))
    del g_np
    vals64 = sec.build_values(h_so, g_so, tabs64)
    diag64 = sec.diagonal_values(vals64, tabs64).reshape(-1)

    def mv64(v):
        return sec.sigma_values(v.reshape(nB, nA), vals64,
                                tabs64).reshape(-1)

    def residual64(v):
        """(x.H x, ||H x - (x.H x) x||) of v normalized, H in float64."""
        v = v.double().reshape(-1)
        v = v / torch.linalg.norm(v)
        hv = mv64(v)
        e = torch.dot(v, hv)
        return float(e), float(torch.linalg.norm(hv - e * v))

    diag32 = sec.diagonal_values(vals32, tabs32).reshape(-1)

    def mv32(v):
        return sec.sigma_values(v.reshape(nB, nA), vals32,
                                tabs32).reshape(-1)

    rule = 1e-6 * max(1.0, abs(r.eigenvalue))
    v, restarts = x32.reshape(-1), []
    t0 = time.perf_counter()     # every Davidson iteration syncs the host
    for _ in range(3):
        res = davidson_ground(mv32, diag32, v, tol=1e-6)
        v = res.eigenvector
        restarts.append(dict(residual=float(res.residual_norm),
                             matvecs=res.iterations,
                             energy=float(res.eigenvalue)))
        if restarts[-1]["residual"] < rule:
            break
    restart_s = time.perf_counter() - t0

    # the solver's first correction at x, all in float32
    xv = x32.reshape(-1)
    hx = mv32(xv)
    t = (hx - torch.dot(xv, hx) * xv) / _guard(diag32 - torch.dot(xv, hx))
    for _ in range(2):
        t = t - torch.dot(xv, t) * xv
    t = t / torch.linalg.norm(t)
    X, HX = torch.stack([xv, t]), torch.stack([hx, mv32(t)])

    def ritz_step(dt):
        G = X.to(dt) @ HX.to(dt).T
        y = torch.linalg.eigh((G + G.T) / 2.0)[1][:, 0].double()
        v, hv = y @ X.double(), y @ HX.double()
        n = torch.linalg.norm(v)
        v, hv = v / n, hv / n
        return dict(coefficient_of_t=float(y[1] / y[0]), residual=float(
            torch.linalg.norm(hv - torch.dot(v, hv) * v)))

    e64_x, rn64_x = residual64(x32)
    t0 = time.perf_counter()
    res64 = davidson_ground(mv64, diag64, x32.reshape(-1).double(), tol=1e-9)
    f64_s = time.perf_counter() - t0
    return dict(sigma_f32_err=sigma_err,
                residual_f32_reported=r.stage_stats["davidson_residuals"][-1],
                residual_f64=rn64_x, energy_f64_of_x=e64_x, rule=rule,
                restarts=restarts, restart_s=restart_s,
                restarts_residual_f64=residual64(v)[1],
                ritz_step={"float32": ritz_step(torch.float32),
                           "float64": ritz_step(f64)},
                energy_f32=r.eigenvalue, energy_f64=float(res64.eigenvalue),
                energy_f64_residual=float(res64.residual_norm),
                energy_f64_matvecs=res64.iterations, energy_f64_s=f64_s)


def phase_parity() -> None:
    import torch
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import gemm
    problem = MoleculeDriver(atom=H2_GEOM, basis="6-31g").run()
    gemm.reset_launch_counts()
    t0 = time.perf_counter()
    r_gpu = _solver(problem, 2, torch.float64, "cuda").compute_minimum_energy()
    gpu_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()
    r_cpu = _solver(problem, 2, torch.float64, "cpu").compute_minimum_energy()
    E = r_gpu.eigenvalue
    if not abs(E - H2_REFERENCE) <= H2_TOL:
        raise AssertionError(f"H2 f64 energy {E!r} not within {H2_TOL} of "
                             f"{H2_REFERENCE}")
    if not abs(E - r_cpu.eigenvalue) <= 1e-8:
        raise AssertionError(f"H2 f64 card {E!r} vs CPU "
                             f"{r_cpu.eigenvalue!r} differ by > 1e-8")
    if routes["fused"] <= 0:
        raise AssertionError("the f64 run did not launch the transform")
    emit("parity", problem="H2 6-31G -> 4 spin orbitals, f64",
         energy_gpu=E, energy_cpu=r_cpu.eigenvalue,
         reference=H2_REFERENCE, tolerance=H2_TOL, gpu_s=gpu_s,
         launches=launches, transform_route_launches=routes)

    import esoo_torch
    f64 = torch.float64
    gemm.reset_launch_counts()
    cas = [_casscf_solver(problem, 2, f64, d,
                          maxiter=20).compute_minimum_energy().eigenvalue
           for d in ("cuda", "cpu")]
    cas_launches = gemm.launch_counts()
    sa = esoo_torch.FusedOptOrbSACASSCF(
        4, k=2, problem=problem, maxiter=20, dtype=f64,
        device="cuda").compute_energies().eigenvalues
    if not (abs(cas[0] - H2_REFERENCE) <= H2_CASSCF_TOL
            and abs(cas[0] - cas[1]) <= 1e-8):
        raise AssertionError(f"H2 CASSCF f64 card {cas[0]!r}, CPU "
                             f"{cas[1]!r}, reference {H2_REFERENCE}")
    if not all(abs(e - ref) <= H2_SA_TOL
               for e, ref in zip(sa, H2_SA_REFERENCE)):
        raise AssertionError(f"H2 SA-CASSCF k=2 {list(sa)} not within "
                             f"{H2_SA_TOL} of {H2_SA_REFERENCE}")
    if cas_launches["gemm.rotate_two_body_cuda"] <= 0:
        raise AssertionError("the CASSCF run did not launch the transform")
    emit("parity_casscf", problem="H2 6-31G -> 4 spin orbitals, f64",
         casscf_gpu=cas[0], casscf_cpu=cas[1], casscf_tolerance=[
             H2_CASSCF_TOL, 1e-8], sa_casscf_gpu=[float(e) for e in sa],
         sa_reference=H2_SA_REFERENCE, sa_tolerance=H2_SA_TOL,
         launches=cas_launches)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import esoo_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    card = phase_device()
    timed = phase_kernels(card)
    paths = {}
    paths["vqe_h4"], problem = phase_main_path()
    phase_profile(problem)
    paths["ssvqe_h4"] = phase_excited(problem)
    del problem
    paths["casscf_h8_n28"], problem = phase_casscf()
    paths["casscf_h8_n32_compact"] = phase_compact(problem)
    del problem
    phase_parity()

    table = []
    # K2's source is the one-pass kernel for n <= 8 (the VQE and SSVQE
    # paths'); n > 8 keeps the four-launch chain of gemm.cu
    sources = {"gemm.matmul": ("esoo_tpu/ops/pallas_kernels.py:80",
                               "esoo_torch/csrc/gemm.cu", {}),
               "gemm.rotate_two_body_cuda": (
                   "esoo_tpu/ops/pallas_kernels.py:108",
                   "esoo_torch/csrc/transform.cu",
                   {"chain_source": "esoo_torch/csrc/gemm.cu (n > 8)"})}
    # launches: the main paths' runs, each with the counts zeroed just
    # before it; the numbers are at the row's `shape`, other shapes nested
    for name, (replaces, source, extra) in sources.items():
        rec = dict(timed[name])
        by_path = {path: counts[name] for path, counts in paths.items()}
        table.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=rec.pop("max_abs_err"), ms=rec.pop("ms"),
            plain_ms=rec.pop("plain_ms"), bound_ms=rec.pop("bound_ms"),
            bound_by=rec.pop("bound_by"), library_ms=rec.pop("library_ms"),
            **extra, **rec))
    emit("done", total_s=time.perf_counter() - t_start)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
