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
            16, and at each of the chain's four stages; the transform
            and K1's stage 1 also at the N2 paths' (26, 8) and (58, 10);
            the one-pass transform at the full path's (112, 6) beside its
            bound, its plain version, the tensordot chain and the K1
            chain; a mesh shard's partial transform (four K1 launches) at
            the mesh phase's shard shapes, (112, 112, 112, 28) with n =
            14 and (56, 56, 56, 14) with n = 4, beside its bound, its
            plain version and the torch.matmul chain;
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
  full      the full-space path (after compact, on the same H8
            integrals): FusedOptOrbVQE(simulation='full') on H8 cc-pVTZ
            (m=112 -> 12 spin orbitals, UCCSD(6, (4, 4)) from HF, 92
            parameters, 640 Pauli rotations on 4,096 amplitudes, f32,
            maxiter 10) with the launch counts zeroed before and read
            after; gates: E within 5e-4 of the JAX package's float64
            energy JAX_H8_12_FULL_F64, the sector solver's first outer
            energy within 1e-4 of the full path's, E at or above the exact
            sector ground energy at the final orbitals, every transform
            launch one-pass; E, the outer trace, the solve's wall, peak
            memory, one L-BFGS evaluation's wall, device ms and launches,
            BB iterations and seconds, L-BFGS evaluations per solve, and
            the card's busy share over a one-outer-iteration solve;
  parity    H2 6-31G -> 4 spin orbitals at f64 on the card against the
            reference energies and the port's own CPU run: FusedOptOrbVQE,
            FusedOptOrbCASSCF and FusedOptOrbSACASSCF (k=2); then the
            full-space simulator (`parity_full`): FusedOptOrbVQE with
            simulation='full' and with 'auto''s fallback for a non-UCC
            circuit, FusedOptOrbVQD with per-state ansatz lists and
            FusedOptOrbAdaptVQE(simulation='full'), each 1e-8 of the CPU
            run; the statevectors of RealAmplitudes(4), EfficientSU2(4)
            and the H8 -> 12 UCCSD circuit against the CPU's (1e-12);
            the Estimator on H2 STO-3G; rdm_energy against the hand
            contraction of one_rdm and two_rdm;
  optorb    the reference library's own class-based API, float64: (a)
            examples/H4_OptOrbVQE.py's configuration on the main path's
            H4 cc-pVTZ problem (m=56 -> 8; OptOrbVQE over VQE(Estimator(),
            UCCSD from HF, L_BFGS_B()), zero start,
            PartialUnitaryProjectionOptimizer(1e-3, 1e-5, 10000), maxiter
            20) with the launch counts zeroed before and read after;
            gates: E within 1e-5 of the JAX package's class-path energy
            JAX_H4_OPTORB_F64 and within 1e-4 of -4.0408844, two one-pass
            transform launches per rotated Hamiltonian; E, the outer
            trace, the solve's wall, result.metrics, the cost-function
            evaluations per outer iteration, BB iterations, peak memory,
            one cost-function evaluation's wall and device ms; (b) on H2
            6-31G -> 4 OptOrbVQE (direct and per-Pauli RDMs),
            OptOrbAdaptVQE, OptOrbSSVQE, OptOrbMCVQE and OptOrbVQD, each
            within 1.5e-3 of the BASELINE.md anchors and 1e-8 of the
            port's CPU run; (c) the reference README's H2 cc-pVTZ -> 4
            OptOrbVQE within 1e-6 of the JAX package's energy, printed
            beside the published one;
  chem      the chemistry past hydrogen, two more main paths, each RHF
            with the two N 1s cores frozen (active_space()) and
            FusedOptOrbCASSCF at f32, the launch counts zeroed before the
            solve and read after: N2 cc-pVDZ m=26 -> 16 spin orbitals,
            maxiter 12, tol 1e-6 (gates: RHF total within 2e-5 of
            -108.954128, (5, 5) in 26 orbitals, CASSCF total within 5e-4
            of -109.102359, the natural occupations of
            tests/test_n2_showcase.py, every transform launch on the
            one-pass route at (26, 8)), then its dipole (|mu| < 1e-4),
            quadrupole and Mulliken populations (14 electrons) from the
            1-RDM on the host; N2 cc-pVTZ m=58 -> 20, 100 outer
            iterations (gates: RHF total within 5e-4 of -108.9835,
            63,504 determinants, E within 5e-4 of the JAX package's
            float64 energy JAX_N2_TZ_20_F64, 4 K1 launches a rotation on
            the chain route at (58, 10), the native C++ ERI engine for
            its f shells); both with the CASSCF gates of the
            casscf phase (E at or below the first outer energy, the final
            Davidson exit and residual, the float64 witness); `chem_s`
            (host integrals, SCF, active space), `solve_s`, `eri_engine`;
  pairs     the pairwise sector kernels (SectorUCC kernel 'pairs'): (a)
            FusedOptOrbVQE on H8 cc-pVTZ -> 12 as in the full phase, but
            on the sector with ESOO_SECTOR_KERNEL=pairs, the launch
            counts zeroed before and read after; gates: E within 5e-4 of
            JAX_H8_12_FULL_F64 and of the string kernel's solve, the
            one-pass transform only; one L-BFGS evaluation on each kernel
            and the busy share; (b) `pairs_oracle`: H8 cc-pVTZ -> 16 (4,900
            determinants, 360 parameters) at f64, pairs against strings
            (state, energy, gradient, RDMs; 1e-10 relative) and the dense
            Hamiltonian's lowest eigenvalue against SectorCI's Davidson
            (1e-8); the structure scan cold and from its disk cache;
  mesh      the orbital mesh over g: (a) FusedOptOrbCASSCF on H8 cc-pVTZ
            -> 28 as in the casscf phase on a 4-shard mesh (four logical
            shards on one card, or four cards), the launch counts zeroed
            before and read after; gates: the casscf phase's (16 K1
            launches a rotation on the shard route), the first outer
            energy within 1e-5 of the unsharded one, and the sharded
            rotation, BB energy and gradient at the unsharded optimum
            against the unsharded ones; (b) `mesh_h4`: FusedOptOrbVQE and
            the class-based OptOrbVQE on H4 cc-pVTZ -> 8 at f64 on the
            mesh, each within 1e-6 of its unsharded run.
`python3 chip_smoke.py --mesh-only` runs device, casscf, the optorb
phase's H4 class solve and mesh alone (for a four-card machine).
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
# N2 past hydrogen (the chem phase): cc-pVDZ, the JAX package's showcase
# (tests/test_n2_showcase.py:21 and :37, totals: the literature RHF and
# its float64 FusedOptOrbCASSCF at 16 spin orbitals), and cc-pVTZ
# (tests/test_basis_universal.py:142, the literature RHF total)
N2_GEOM = "N 0 0 0; N 0 0 1.0977"
N2_DZ_RHF = -108.954128
N2_DZ_RHF_TOL = 2e-5
N2_DZ_CASSCF = -109.102359
N2_TZ_RHF = -108.9835
N2_TOL = 5e-4
N2_CASSCF_KW = dict(maxiter=12, stopping_tolerance=1e-6)
# N2 cc-pVTZ 58 -> 20 creeps down a flat valley for a hundred outer
# iterations and more, and on the way the float32 trajectory parts from
# the float64 one by more than N2_TOL.
# So the path runs 100 outer iterations with no early stop (at |E| ~ 32 a
# float32 |dE| below 1e-6 is two equal roundings, not convergence), and
# the gate is the JAX package's float64 energy at the same settings
# (tests/test_torch_n2.py recomputes it).
N2_TZ_KW = dict(maxiter=100, stopping_tolerance=0.0)
JAX_N2_TZ_20_F64 = -31.746012714748243
# the full-space path (the `full` phase): FusedOptOrbVQE on H8 cc-pVTZ
# m=112 -> 12 spin orbitals, UCCSD(6, (4, 4)) from HF (92 parameters,
# 640 Pauli rotations on 4,096 amplitudes), simulation='full', f32, the
# (12, "full", "one") configuration of bench.py:307 run_h8_scale.  The
# gate: the JAX package's float64 energy at the same settings
# (tests/test_torch_full.py's slow case recomputes it); its f32 run on
# the CPU lands 4.3e-5 above it, and the two traces part by up to ~1e-3
# on the way, so only the final energy is gated
H8_FULL_KW = dict(maxiter=10, stopping_tolerance=1e-5)
JAX_H8_12_FULL_F64 = -10.183879808455526
H8_FULL_TOL = 5e-4
# the pairs phase: the H8 -> 12 solve on the pairwise kernels against
# the JAX package's float64 energy and the string kernel's, and the
# kernels' oracle at H8 -> 16 (pairs against strings, float64, relative)
PAIRS_TOL = 5e-4
PAIRS_ORACLE_TOL = 1e-10
# the mesh phase: the sharded H8 -> 28 CASSCF's first outer energy
# against the casscf phase's (f32, the same U0), and the H4 -> 8 float64
# solves against their unsharded runs
MESH_TOL = 1e-5
MESH_F64_TOL = 1e-6
# BENCH_r02.json's record of this configuration (the JAX package on a
# TPU v5e, older code): printed beside E, not gated
BENCH_R02_H8_12 = -10.1839046
# FusedOptOrbVQE on H2 6-31G -> 4 with the non-UCC real circuit of
# tests/test_fused.py:462-467 (simulation 'auto' falls back to full): the
# JAX package's float64 energy on the CPU (tests/test_torch_full.py holds
# the port's CPU run to it at 1e-8)
H2_FALLBACK_JAX_F64 = -1.846778352577036

# the class-based path (the `optorb` phase): examples/H4_OptOrbVQE.py's
# configuration through the reference API (OptOrbVQE over VQE(Estimator(),
# UCCSD(4, (2, 2)) from HF, L_BFGS_B()) with a zero start,
# PartialUnitaryProjectionOptimizer(1e-3, 1e-5, 10000), maxiter 20,
# wavefuntion_real and spin_conserving, float64) on H4 cc-pVTZ m=56 -> 8,
# and the reference README's H2 cc-pVTZ -> 4: the JAX package's class-path
# energies at those settings on the CPU (tests/test_torch_optorb.py's slow
# case recomputes both)
JAX_H4_OPTORB_F64 = -4.040882305949296
H4_OPTORB_TOL = 1e-5
JAX_H2_TZ_OPTORB_F64 = -1.8711467207110213
H2_TZ_OPTORB_TOL = 1e-6
# the reference README's published H2 cc-pVTZ OptOrbVQE energy
# (BASELINE.md, bench.py:71): printed beside E, not gated
PUBLISHED_H2_TZ = -1.8712471686505392

# the narrow K1 kernel's check shapes (M, K, N), x^T y with x (K, M): N
# from 1 to 16; M ragged against a tile and not a multiple of 4; K of one
# ring stage, of 7 and of 19 (y in two chunks at float32, three at
# float64, N = 16)
NARROW_SHAPES = ([(729, 112, n) for n in (1, 4, 5, 8, 12, 14, 16)]
                 + [(4097, k, 16) for k in (1, 3, 112, 300)]
                 + [(729, 300, 5), (4098, 7, 14)])
# stage 1 of the transform's chain at m=112: the n of the sweep
K1_SWEEP_N = (4, 8, 12, 14, 16)
# one shard of g on the `mesh` phase's 4-shard meshes, (m, m_loc, n): H8
# cc-pVTZ -> 28 and H4 cc-pVTZ -> 8
MESH_SHARD_SHAPES = ((112, 28, 14), (56, 14, 4))

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
        # odd m (element-wise copies), more blocks than slabs and the N2
        # cc-pVDZ path's (26, 8); the four-launch chain (gemm.cu) at n = 12
        # and at the N2 cc-pVTZ path's (58, 10)
        for (mm, nn, route) in ((56, 4, "fused"), (24, 8, "fused"),
                                (9, 3, "fused"), (4, 2, "fused"),
                                (26, 8, "fused"), (24, 12, "chain"),
                                (58, 10, "chain")):
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
    at_n2 = _kernels_at_n2_shapes((bw, fl32))
    at_full = _transform_at_full_shape(checks, (bw, fl32))
    at_shard = {f"shard_at_m{mm}_mloc{ml}_n{nn}":
                _transform_shard(checks, mm, ml, nn, (bw, fl32))
                for mm, ml, nn in MESH_SHARD_SHAPES}
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
         matmul_stage1_m112_sweep=k1_sweep, at_n2_shapes=at_n2,
         rotate_two_body_cuda_m112_n6=at_full,
         rotate_two_body_shard=at_shard,
         timing=f"ms: median over 50 calls after 5 warm-up of CUDA events "
         f"around each call, the calls queued behind a device spin (no host "
         f"launch gaps); kernel_ms: profiler kernel time per call; "
         f"host_100_calls_ms: host wall of 100 calls and one sync; {card}")
    return {"gemm.matmul": dict(k1_h8, shape="m=112 n=14 stage 1 "
                                "(1404928x112)^T @ (112x14)",
                                at_h4_stage1=k1, at_m112_n16=k1_h8_16,
                                stage1_m112_sweep=k1_sweep,
                                stage1_at_m58_n10=at_n2["matmul_stage1"],
                                **at_shard),
            "gemm.rotate_two_body_cuda": dict(
                k2, shape="m=56 n=4 one-pass kernel",
                chain_at_m112_n14=chain_h8, chain_at_m112_n16=chain_h8_16,
                at_m26_n8=at_n2["one_pass"],
                chain_at_m58_n10=at_n2["chain"], at_m112_n6=at_full)}


def _kernels_at_n2_shapes(peak: tuple) -> dict:
    """The transform at the N2 paths' shapes, float32: the one-pass kernel
    at (26, 8) (cc-pVDZ; g is 1.8 MB, L2-resident on the path, also timed
    after a 128 MB write), the K1 chain at (58, 10) (cc-pVTZ; g is 45 MB)
    and the chain's stage 1, (195112 x 58)^T @ (58 x 10); each beside its
    bound, its plain version and the library call.  Held against the
    plain versions in the kernels phase's checks."""
    import torch
    from esoo_torch.ops import gemm
    dev, f32 = torch.device("cuda"), torch.float32
    bw, fl32 = peak
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {}
    for key, (m, n, route, match) in {
            "one_pass": (26, 8, "fused", "transform_"),
            "chain": (58, 10, "chain", "gemm_")}.items():
        if gemm._transform_plan(m, n, 4)[0] != route:
            raise AssertionError(f"m={m} n={n} should take the {route} "
                                 f"route")
        g = torch.randn((m,) * 4, dtype=f32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(m))
        u = _partial_unitary(m, n, f32,
                             torch.Generator().manual_seed(n)).to(dev)

        def call(g=g, u=u):
            return gemm.rotate_two_body_cuda(g, u)

        def cold(g=g, u=u):
            flush.zero_()
            return gemm.rotate_two_body_cuda(g, u)

        def library(g=g, u=u):
            t = torch.tensordot(g, u, dims=([0], [0]))
            t = torch.tensordot(t, u, dims=([0], [0]))
            t = torch.tensordot(t, u, dims=([0], [0]))
            return torch.tensordot(t, u, dims=([0], [0]))

        kms, events = device_profile(call, match=match)
        rec = dict(m=m, n=n, route=route, kernel_ms=kms,
                   kernel_launches_per_call=events,
                   kernel_ms_l2_flushed=kernel_ms(cold, match=match),
                   ms=time_ms(call),
                   plain_ms=time_ms(lambda g=g, u=u:
                                    gemm.rotate_two_body_plain(g, u)),
                   library_ms=time_ms(library),
                   max_abs_err=float((call() - library()).abs().max()))
        nbytes = 4 * (m ** 4 + m * n + n ** 4)
        if route == "fused":        # the one-pass kernel's FMAs
            flops = 2 * (m * m * (m * m * n + m * n * n)
                         + m * (m * n ** 3 + n ** 4))
        else:                       # the chain's four stages
            flops = 2 * (m ** 4 * n + m ** 3 * n ** 2 + m ** 2 * n ** 3
                         + m * n ** 4)
        t_bytes, t_ops = nbytes / bw * 1e3, flops / fl32 * 1e3
        rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rec["pct_of_bound"] = 100 * rec["bound_ms"] / rec["kernel_ms"]
        out[key] = rec
        if route == "chain":
            x = g.reshape(m, m ** 3)

            def k1(x=x, u=u):
                return gemm.matmul(x, u, trans_x=True)

            out["matmul_stage1"] = _k1_bounded(dict(
                m=m, n=n, kernel_ms=kernel_ms(k1, match="gemm_"),
                ms=time_ms(k1), plain_ms=time_ms(
                    lambda x=x, u=u: gemm.matmul_plain(x, u, trans_x=True)),
                library_ms=time_ms(lambda x=x, u=u: torch.matmul(x.T, u)),
                max_abs_err=float((k1() - torch.matmul(x.T, u))
                                  .abs().max())), m, m ** 3, n, peak)
    return out


def _transform_at_full_shape(checks: list, peak: tuple) -> dict:
    """The one-pass transform at the full-space path's (m, n) = (112, 6),
    float32: its first run at m = 112 (a 4-slab ring of 112 x 112 slabs,
    one block an SM).  Held against its plain version (two calls bit for
    bit), its kernel time beside its bound, the plain version's, the
    tensordot chain's (the library call) and the K1 chain's at the same
    shape.  The 629 MB g never fits the 50 MB L2."""
    import torch
    from esoo_torch.ops import gemm
    dev, f32 = torch.device("cuda"), torch.float32
    m, n = 112, 6
    if gemm._transform_plan(m, n, 4) != ("fused", 4):
        raise AssertionError(f"m={m} n={n} planned "
                             f"{gemm._transform_plan(m, n, 4)}, expected "
                             f"('fused', 4)")
    g = torch.randn((m,) * 4, dtype=f32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    u = _partial_unitary(m, n, f32, torch.Generator().manual_seed(6)).to(dev)

    def call():
        return gemm.rotate_two_body_cuda(g, u)

    def chain():
        return gemm.rotate_two_body_chain(g, u)

    def library():
        t = torch.tensordot(g, u, dims=([0], [0]))
        t = torch.tensordot(t, u, dims=([0], [0]))
        t = torch.tensordot(t, u, dims=([0], [0]))
        return torch.tensordot(t, u, dims=([0], [0]))

    out, again = call(), call()
    torch.cuda.synchronize()
    err = check_close(out, gemm.rotate_two_body_plain(g, u), f32,
                      "rotate_two_body_cuda m=112 n=6 one-pass")
    if not torch.equal(out, again):
        raise AssertionError("two one-pass calls at m=112 n=6 differ")
    checks.append(dict(kernel="gemm.rotate_two_body_cuda", route="fused",
                       m=m, n=n, dtype=str(f32), err=err, shape="full",
                       repeat_bit_identical=True))
    kms, events = device_profile(call, match="transform_")
    bw, fl32 = peak
    nbytes = 4 * (m ** 4 + m * n + n ** 4)
    flops = 2 * (m * m * (m * m * n + m * n * n) + m * (m * n ** 3 + n ** 4))
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl32 * 1e3
    rec = dict(m=m, n=n, route="fused", stages=4, kernel_ms=kms,
               kernel_launches_per_call=events, ms=time_ms(call),
               plain_ms=time_ms(lambda: gemm.rotate_two_body_plain(g, u)),
               library_ms=time_ms(library), chain_ms=time_ms(chain),
               chain_kernel_ms=kernel_ms(chain, match="gemm_"),
               max_abs_err=float((call() - library()).abs().max()),
               bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    rec["pct_of_bound"] = 100 * rec["bound_ms"] / kms
    return rec


def _transform_shard(checks: list, m: int, m_loc: int, n: int,
                     peak: tuple) -> dict:
    """One mesh shard's partial transform (gemm.rotate_two_body_shard:
    four K1 launches, stage 4 over the shard's m_loc rows) at a mesh
    path's shape, float32 and float64, held against its plain version;
    at float32 its time beside its bound, the plain version's and the
    torch.matmul chain's (the library call) in the same layout."""
    import torch
    from esoo_torch.ops import gemm
    dev = torch.device("cuda")
    dgen = torch.Generator(device=dev).manual_seed(m + m_loc)
    for dtype in (torch.float64, torch.float32):
        g_loc = torch.randn((m, m, m, m_loc), dtype=dtype, device=dev,
                            generator=dgen)
        u = _partial_unitary(m, n, dtype,
                             torch.Generator().manual_seed(n)).to(dev)
        u_loc = u[:m_loc].contiguous()
        out = gemm.rotate_two_body_shard(g_loc, u, u_loc)
        torch.cuda.synchronize()
        err = check_close(out, gemm.rotate_two_body_shard_plain(
            g_loc, u, u_loc), dtype, f"rotate_two_body_shard m={m} "
            f"m_loc={m_loc} n={n}")
        checks.append(dict(kernel="gemm.matmul", route="shard", m=m,
                           m_loc=m_loc, n=n, dtype=str(dtype), err=err))

    def call():
        return gemm.rotate_two_body_shard(g_loc, u, u_loc)

    def library():
        t = torch.matmul(g_loc.reshape(m, -1).T, u)
        t = torch.matmul(t.reshape(m, -1).T, u)
        t = torch.matmul(t.reshape(m, -1).T, u)
        return torch.matmul(t.reshape(m_loc, -1).T, u_loc).reshape((n,) * 4)

    kms, events = device_profile(call, match="gemm_")
    bw, fl32 = peak
    nbytes = 4 * (m ** 3 * m_loc + m * n + m_loc * n + n ** 4)
    flops = 2 * (m ** 3 * m_loc * n + m * m * m_loc * n ** 2
                 + m * m_loc * n ** 3 + m_loc * n ** 4)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / fl32 * 1e3
    rec = dict(m=m, m_loc=m_loc, n=n, kernel_ms=kms,
               kernel_launches_per_call=events, ms=time_ms(call),
               plain_ms=time_ms(lambda: gemm.rotate_two_body_shard_plain(
                   g_loc, u, u_loc)),
               library_ms=time_ms(library),
               library_kernel_ms=kernel_ms(library),
               max_abs_err=float((call() - library()).abs().max()),
               bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    rec["pct_of_bound"] = 100 * rec["bound_ms"] / kms
    return rec


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


def busy_share(fn) -> tuple:
    """(wall seconds, device-busy seconds) of one call of `fn`, the device
    time summed over the kernels and copies torch.profiler records (CUDA
    activity only, so the host's own profiling adds little to the
    wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, sum(t for _, t in _device_events(prof)) / 1e6


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
    return launches, problem, dict(energy=E, first=trace[0],
                                   solve_s=solve_s, bb_s=stats["bb_s"],
                                   peak_memory_bytes=peak_bytes,
                                   U=r.optimal_partial_unitary,
                                   V=r.optimal_point)


def _casscf_gates(r, witness: dict, launches: dict, routes: dict,
                  route: str = "chain", shards: int = 1) -> list:
    """The gates every CASSCF solve of the smoke meets beside its energy
    window; `route` is the transform's route at the solve's (m, n), or
    "shard" for a mesh of `shards` shards (four K1 launches each)."""
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
    # every rotation is the transform's four-launch K1 chain (n > 8), one
    # C call of the one-pass kernel, two launches (n <= 8), or on a mesh
    # four K1 launches a shard
    per = {"chain": 4, "fused": 2, "shard": 4 * shards}[route]
    expected = {"fused": 0, "chain": 0, "shard": 0}
    expected[route] = per * rotations
    if not (rotations == r.outer_iterations + 1
            and launches["gemm.matmul"] == expected["chain"]
            + expected["shard"]
            and launches["gemm.rotate_two_body_cuda"]
            == expected["chain"] + expected["fused"]
            and routes == expected):
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


def _full_solver(problem, simulation: str, dtype, device, **kw):
    """FusedOptOrbVQE on H8 cc-pVTZ -> 12 spin orbitals: UCCSD(6, (4, 4))
    from Hartree-Fock (92 parameters; 8 X gates merged into the start
    index and 640 Pauli rotations)."""
    import esoo_torch as T
    ansatz = T.UCCSD(6, (4, 4), initial_state=T.HartreeFock(6, (4, 4)))
    return T.FusedOptOrbVQE(num_spin_orbitals=12, ansatz=ansatz,
                            problem=problem, simulation=simulation,
                            dtype=dtype, device=device, **kw)


def phase_full(problem) -> dict:
    """The full-space path: FusedOptOrbVQE(simulation='full') on H8
    cc-pVTZ (m=112 -> 12 spin orbitals, 4,096 amplitudes), f32, maxiter
    10, tol 1e-5 (bench.py:307 run_h8_scale's defaults), the launch
    counts zeroed just before the solve and read just after.  Gates: (a)
    E within H8_FULL_TOL of JAX_H8_12_FULL_F64; (b) the first outer
    energy of the same solver on the sector within 1e-4 of the full
    path's (the same unitary from the same U0); (c) E at or above the
    exact sector ground energy at the final orbitals, less 1e-6; (d)
    every transform launch on the one-pass route.  Then one L-BFGS
    evaluation's wall, device time and launches at the final state, and
    the card's busy share over a one-outer-iteration solve."""
    import torch
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.stiefel import value_and_grad
    from esoo_torch.sim.rdm import rdm_energy
    f32, dev = torch.float32, "cuda"
    if problem.num_spatial_orbitals != 112:
        raise AssertionError(f"H8 cc-pVTZ gave m="
                             f"{problem.num_spatial_orbitals}, expected 112")
    t0 = time.perf_counter()
    solver = _full_solver(problem, "full", f32, dev, **H8_FULL_KW)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prots = sum(g.name == "prot" for g in solver.ansatz.gates)

    held_bytes = torch.cuda.memory_allocated()   # earlier phases' too
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

    sector = _full_solver(problem, "sector", f32, dev, maxiter=1)
    sector_first = sector.compute_minimum_energy().energy_convergence_list[0]
    U = torch.as_tensor(r.optimal_partial_unitary, device=dev)
    lam = _exact_sector_spectrum(problem, U, 6, (4, 4))

    # one L-BFGS evaluation at the final state: the 640-gate scan, the
    # direct-RDM energy, and the backward through both
    theta = torch.as_tensor(r.optimal_point, device=dev)
    h_so, g_so = K.expand_spin_tensors(K.rotate_one_body(solver._h_sp, U),
                                       K.rotate_two_body(solver._g_sp, U))
    vag = value_and_grad(lambda th: rdm_energy(
        solver._compiled.state_fn(th, f32), h_so, g_so))
    vag(theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        vag(theta)
    torch.cuda.synchronize()
    eval_wall_ms = (time.perf_counter() - t0) / 10 * 1e3
    eval_ms, eval_events = device_profile(lambda: vag(theta), reps=3)

    # the card's busy share over a one-outer-iteration solve (a whole
    # solve would hold a million profiler events)
    window = _full_solver(problem, "full", f32, dev, maxiter=1)
    window_s, busy_s = busy_share(window.compute_minimum_energy)

    solves = r.outer_iterations + 1            # the loop's and the tail's
    failed = []
    if not abs(E - JAX_H8_12_FULL_F64) <= H8_FULL_TOL:
        failed.append(f"(a) energy {E!r} not within {H8_FULL_TOL} of the "
                      f"JAX package's float64 {JAX_H8_12_FULL_F64}")
    if not abs(trace[0] - sector_first) <= 1e-4:
        failed.append(f"(b) first outer energy {trace[0]!r} vs the "
                      f"sector's {sector_first!r}")
    if not E >= lam[0] - 1e-6:
        failed.append(f"(c) energy {E!r} below the exact sector ground "
                      f"energy {lam[0]!r} at the final orbitals")
    if not (launches["gemm.rotate_two_body_cuda"] > 0
            and launches["gemm.matmul"] == 0 and routes["chain"] == 0):
        failed.append(f"(d) launches {launches}, routes {routes}: the "
                      f"one-pass transform only")
    emit("full", problem="H8 cc-pVTZ m=112 -> 12 spin orbitals, (4, 4) "
         "electrons, UCCSD(6, (4, 4)) from HF, simulation='full', 4,096 "
         "amplitudes, f32, maxiter 10, tol 1e-5", energy=E,
         jax_f64=JAX_H8_12_FULL_F64, tolerance=H8_FULL_TOL,
         bench_r02_tpu=BENCH_R02_H8_12, sector_first_outer=sector_first,
         exact_sector_ground=float(lam[0]), outer_trace=trace,
         outer_iterations=r.outer_iterations, parameters=len(theta),
         pauli_rotations=prots, setup_s=setup_s, solve_s=solve_s,
         peak_memory_bytes=peak_bytes, held_before_solve_bytes=held_bytes,
         stage_stats=stats, lbfgs_evaluations_per_solve=stats["lbfgs_evaluations"] / solves,
         bb_iterations=stats["bb_iterations"], bb_s=stats["bb_s"],
         lbfgs_evaluation_wall_ms=eval_wall_ms,
         lbfgs_evaluation_device_ms=eval_ms,
         lbfgs_evaluation_device_events=eval_events,
         busy_window=dict(maxiter=1, wall_s=window_s, device_busy_s=busy_s,
                          device_busy_share=busy_s / window_s),
         launches=launches, transform_route_launches=routes,
         gates_failed=failed)
    if failed:
        raise AssertionError("H8 full-space gates failed: "
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
    _parity_full(problem)


def _parity_full(problem) -> None:
    """The full-space simulator at f64, card against the port's CPU run:
    on H2 6-31G -> 4 FusedOptOrbVQE(simulation='full'), 'auto''s
    fallback for a non-UCC real circuit, FusedOptOrbVQD with per-state
    ansatz lists and FusedOptOrbAdaptVQE(simulation='full') (each 1e-8 of
    the CPU run and within its anchor); the statevectors of
    RealAmplitudes(4) (real path), EfficientSU2(4) (complex path) and the
    H8 -> 12 UCCSD circuit at seeded theta (1e-12 of the CPU's); the
    Estimator's H2 STO-3G energy on both; and rdm_energy against one_rdm
    and two_rdm contracted by hand."""
    import esoo_torch as T
    import numpy as np
    import torch
    from esoo_torch.ops import ActiveSpaceHamiltonianBuilder, gemm
    from esoo_torch.sim import (Estimator, one_rdm, rdm_energy, statevector,
                                two_rdm)
    f64, hf = torch.float64, T.HartreeFock(2, (1, 1))

    def fallback():
        qc = T.QuantumCircuit(4)
        qc.x(0)
        qc.x(2)
        qc.ry(qc.parameter(), 1)
        qc.cx(1, 3)
        return qc

    kw = dict(problem=problem, maxiter=20, dtype=f64)
    makers = {
        "vqe_full": (lambda d: T.FusedOptOrbVQE(
            4, T.UCCSD(2, (1, 1), initial_state=hf), simulation="full",
            device=d, **kw), (H2_REFERENCE,), H2_TOL),
        "vqe_auto_fallback": (lambda d: T.FusedOptOrbVQE(
            4, fallback(), device=d, **kw), (H2_FALLBACK_JAX_F64,), 1e-6),
        "vqd_per_state": (lambda d: T.FusedOptOrbVQD(
            4, [T.UCCSD(2, (1, 1)), T.UCCSD(2, (1, 1), reps=2)],
            initial_states=[hf, T.OccupationState(4, 0b0110)], betas=[2.0],
            weight_vector=[2, 1], device=d, **kw),
            H2_EXCITED_ANCHORS["vqd"], H2_ANCHOR_TOL),
        "adapt_full": (lambda d: T.FusedOptOrbAdaptVQE(
            4, T.UCCSD(2, (1, 1), initial_state=hf), simulation="full",
            device=d, **kw), H2_EXCITED_ANCHORS["adapt"], H2_ANCHOR_TOL)}
    runs, failed = {}, []
    for name, (make, anchors, tol) in makers.items():
        out = []
        for d in ("cuda", "cpu"):
            solver = make(d)
            gemm.reset_launch_counts()
            if hasattr(solver, "compute_energies"):
                es = solver.compute_energies().eigenvalues
            else:
                es = [solver.compute_minimum_energy().eigenvalue]
            out.append([float(e) for e in es])
            if d == "cuda":
                fused = gemm.route_launch_counts()["fused"]
        card_e, cpu_e = out
        runs[name] = dict(card=card_e, cpu=cpu_e, simulation=solver.simulation,
                          transform_launches=fused)
        if not (solver.simulation == "full" and fused > 0
                and max(abs(a - b) for a, b in zip(card_e, cpu_e)) <= 1e-8
                and all(abs(a - b) <= tol
                        for a, b in zip(card_e, anchors))):
            failed.append(f"{name}: card {card_e}, CPU {cpu_e}, anchors "
                          f"{anchors} (tol {tol}), simulation "
                          f"{solver.simulation}, {fused} launches")

    gen = np.random.default_rng(12)
    circuits = {"real_amplitudes": T.RealAmplitudes(4),
                "efficient_su2": T.EfficientSU2(4),
                "uccsd_h8_12": T.UCCSD(6, (4, 4),
                                       initial_state=T.HartreeFock(6, (4, 4)))}
    sv = {}
    for name, qc in circuits.items():
        theta = gen.normal(size=qc.num_parameters) * 0.1
        card = statevector(qc, theta, device="cuda")
        cpu = statevector(qc, theta, device="cpu")
        err = float((card.cpu() - cpu).abs().max())
        sv[name] = dict(dtype=str(card.dtype), max_abs_err=err,
                        gates=len(qc.gates))
        if not err <= 1e-12:
            failed.append(f"statevector {name}: card vs CPU {err:.3e}")
    # the Estimator on H2 STO-3G's qubit Hamiltonian (its direct-RDM path)
    from esoo_torch.chem import MoleculeDriver
    sto3g = MoleculeDriver(atom=H2_GEOM, basis="sto-3g").run()
    H = ActiveSpaceHamiltonianBuilder(4).build(*sto3g.integral_tensors())
    ans = T.UCCSD(2, (1, 1), initial_state=hf)
    est = [Estimator(device=d).run(ans, H, [0.1, -0.2, 0.3]).result()
           .values[0] for d in ("cuda", "cpu")]
    if not abs(est[0] - est[1]) <= 1e-12:
        failed.append(f"Estimator card {est[0]!r} vs CPU {est[1]!r}")
    # rdm_energy against one_rdm/two_rdm contracted by hand, at the H8
    # UCCSD state and seeded symmetric integrals
    N = 12
    state = statevector(circuits["uccsd_h8_12"],
                        gen.normal(size=92) * 0.1, device="cuda")
    hr = torch.as_tensor(gen.normal(size=(N, N)), device="cuda")
    gr = torch.as_tensor(gen.normal(size=(N,) * 4) * 0.1, device="cuda")
    hr = (hr + hr.T) / 2
    e_direct = float(rdm_energy(state, hr, gr))
    e_hand = float(torch.sum(hr * one_rdm(state, N))
                   + torch.sum(gr * two_rdm(state, N)))
    if not abs(e_direct - e_hand) <= 1e-12 * max(1.0, abs(e_hand)):
        failed.append(f"rdm_energy {e_direct!r} vs by hand {e_hand!r}")
    emit("parity_full", problem="H2 6-31G -> 4 spin orbitals, f64; "
         "statevectors at seeded theta, f64", runs=runs, statevectors=sv,
         estimator_card_cpu=est, rdm_energy=[e_direct, e_hand],
         tolerance=dict(energies=1e-8, statevectors=1e-12,
                        rdm_energy=1e-12), gates_failed=failed)
    if failed:
        raise AssertionError("full-space parity failed: " + "; ".join(failed))


def _class_optorbvqe(problem, n_act: int, device: str, **kw):
    """OptOrbVQE through the class API at examples/H4_OptOrbVQE.py's
    settings (float64, the dtype policy's default)."""
    import numpy as np

    import esoo_torch as T
    parts = problem.num_particles
    ansatz = T.UCCSD(n_act, parts,
                     initial_state=T.HartreeFock(n_act, parts))
    vqe = T.VQE(T.Estimator(device=device), ansatz, T.L_BFGS_B(),
                initial_point=np.zeros(ansatz.num_parameters), device=device)
    return T.OptOrbVQE(
        num_spin_orbitals=2 * n_act, ground_state_solver=vqe,
        partial_unitary_optimizer=T.PartialUnitaryProjectionOptimizer(
            1e-3, 1e-5, 10000, device=device),
        problem=problem, maxiter=20, wavefuntion_real=True,
        spin_conserving=True, device=device, **kw)


def _class_h2_runs(h2, device: str) -> dict:
    """The class-based family on H2 6-31G -> 4 at float64 on `device`:
    the reference's tests/test_opt_orb*.py drives."""
    import numpy as np

    import esoo_torch as T
    dk = {"device": device}

    def pupo():
        return T.PartialUnitaryProjectionOptimizer(1e-3, 1e-5, 10000, **dk)

    def vqe(ansatz, **kw):
        return T.VQE(T.Estimator(**dk), ansatz, T.L_BFGS_B(), **dk, **kw)

    def hf_uccsd(**kw):
        return T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(2, (1, 1)),
                       **kw)

    def zeros(a):
        return np.zeros(a.num_parameters)

    init1 = T.QuantumCircuit(4)
    init1.x(1)
    init1.x(2)
    common = dict(num_spin_orbitals=4, problem=h2, maxiter=20, **dk)
    out = {}
    for rdm in ("direct", "pauli"):
        a = hf_uccsd()
        out[f"vqe_{rdm}"] = [T.OptOrbVQE(
            ground_state_solver=vqe(a, initial_point=zeros(a)),
            partial_unitary_optimizer=pupo(), rdm_measurement=rdm,
            spin_conserving=True, wavefuntion_real=True,
            **common).compute_minimum_energy().eigenvalue]
    out["adapt"] = [T.OptOrbAdaptVQE(
        ground_state_solver=T.AdaptVQE(vqe(hf_uccsd())),
        partial_unitary_optimizer=pupo(),
        **common).compute_minimum_energy().eigenvalue]
    a = T.UCCSD(2, (1, 1), reps=2)
    out["ssvqe"] = list(T.OptOrbSSVQE(
        excited_states_solver=T.SSVQE(
            k=2, ansatz=a, optimizer=T.L_BFGS_B(),
            initial_states=[T.HartreeFock(2, (1, 1)), init1],
            weight_vector=[2, 1], initial_point=zeros(a), **dk),
        partial_unitary_optimizer=pupo(), **common).compute_energies(
    ).eigenvalues)
    out["mcvqe"] = list(T.OptOrbMCVQE(
        excited_states_solver=T.MCVQE(
            k=2, ansatz=a, optimizer=T.L_BFGS_B(), num_particles=(1, 1),
            excitations="s", initial_point=zeros(a), **dk),
        partial_unitary_optimizer=pupo(), **common).compute_energies(
    ).eigenvalues)
    ansatze = [T.UCCSD(2, (1, 1), initial_state=st, reps=2)
               for st in (T.HartreeFock(2, (1, 1)), init1)]
    out["vqd"] = list(T.OptOrbVQD(
        excited_states_solver=T.VQD(
            T.Estimator(**dk), T.ComputeUncompute(T.Sampler(**dk)), ansatze,
            T.L_BFGS_B(), k=2, betas=[2, 2],
            initial_point=[zeros(x) for x in ansatze], **dk),
        partial_unitary_optimizer=pupo(), **common).compute_energies(
    ).eigenvalues)
    return {k: [float(e) for e in v] for k, v in out.items()}


def phase_optorb(h4) -> dict:
    """The class-based API on the card: (a) examples/H4_OptOrbVQE.py's
    configuration on the main path's H4 cc-pVTZ problem (m=56 -> 8,
    float64) with the launch counts zeroed before and read after; (b) the
    class-based family on H2 6-31G -> 4 against the BASELINE.md anchors
    and the port's CPU runs; (c) the reference README's H2 cc-pVTZ -> 4."""
    import numpy as np
    import torch

    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import gemm
    from esoo_torch.solvers.energy import make_evaluators

    failed = []
    evals = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    solver = _class_optorbvqe(
        h4, 4, "cuda",
        outer_loop_callback=lambda it, res, orb: evals.append(
            res.cost_function_evals))
    gemm.reset_launch_counts()
    t0 = time.perf_counter()
    r = solver.compute_minimum_energy()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 20
    rebuilds = len(r.metrics["hamiltonian_time"])
    E = float(r.eigenvalue)
    if not abs(E - JAX_H4_OPTORB_F64) <= H4_OPTORB_TOL:
        failed.append(f"E {E!r} not within {H4_OPTORB_TOL} of the JAX "
                      f"package's {JAX_H4_OPTORB_F64}")
    if not abs(E - H4_REFERENCE) <= H4_TOL:
        failed.append(f"E {E!r} not within {H4_TOL} of {H4_REFERENCE}")
    if not (launches["gemm.rotate_two_body_cuda"] > 0 and routes["chain"] == 0
            and routes["fused"] == 2 * rebuilds):
        failed.append(f"launches {launches}, routes {routes}: two one-pass "
                      f"launches per rotated Hamiltonian ({rebuilds})")

    # one cost-function evaluation at the final Hamiltonian and optimum:
    # the sector gate scan and sigma, forward and backward, and the
    # gradient's copy to the host for SciPy
    _, vag = make_evaluators(solver.ground_state_solver_list[0].ansatz,
                             solver._hamiltonian, "cuda")
    theta = np.asarray(r.optimal_point)
    vag(theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        vag(theta)
    eval_wall_ms = (time.perf_counter() - t0) / 20 * 1e3
    eval_ms, eval_events = device_profile(lambda: vag(theta))
    # the card's busy share over one more (warm) solve
    warm = _class_optorbvqe(h4, 4, "cuda")
    warm_s, busy_s = busy_share(warm.compute_minimum_energy)
    emit("optorb", problem="H4 cc-pVTZ m=56 -> 8 spin orbitals, OptOrbVQE "
         "through the class API (examples/H4_OptOrbVQE.py: UCCSD from HF, "
         "26 parameters, zero start, L_BFGS_B, PUPO(1e-3, 1e-5, 10000), "
         "maxiter 20), f64", energy=E, jax_f64=JAX_H4_OPTORB_F64,
         tolerance=[H4_OPTORB_TOL, H4_TOL], reference=H4_REFERENCE,
         outer_trace=r.energy_convergence_list, solve_s=solve_s,
         metrics=r.metrics, cost_function_evals=evals,
         cost_function_evals_total=sum(evals),
         bb_iterations=r.orbital_rotation_iterations,
         peak_mb=peak_mb, launches=launches,
         transform_route_launches=routes, hamiltonian_rebuilds=rebuilds,
         cost_function_evaluation_wall_ms=eval_wall_ms,
         cost_function_evaluation_device_ms=eval_ms,
         cost_function_evaluation_device_events=eval_events,
         warm_solve_s=warm_s, warm_device_busy_s=busy_s,
         warm_device_busy_share=busy_s / warm_s, gates_failed=failed)
    if failed:
        raise AssertionError("optorb H4 gates failed: " + "; ".join(failed))

    h2 = MoleculeDriver(atom=H2_GEOM, basis="6-31g").run()
    anchors = {"vqe_direct": (H2_REFERENCE,), "vqe_pauli": (H2_REFERENCE,),
               **H2_EXCITED_ANCHORS}
    t0 = time.perf_counter()
    card = _class_h2_runs(h2, "cuda")
    card_s = time.perf_counter() - t0
    cpu = _class_h2_runs(h2, "cpu")
    for name, es in card.items():
        if not (max(abs(a - b) for a, b in zip(es, cpu[name])) <= 1e-8
                and all(abs(a - b) <= H2_ANCHOR_TOL
                        for a, b in zip(es, anchors[name]))):
            failed.append(f"{name}: card {es}, CPU {cpu[name]}, anchors "
                          f"{anchors[name]}")
    h2tz = MoleculeDriver(atom=H2_GEOM, basis="cc-pvtz").run()
    t0 = time.perf_counter()
    e_tz = float(_class_optorbvqe(h2tz, 2, "cuda").compute_minimum_energy()
                 .eigenvalue)
    tz_s = time.perf_counter() - t0
    if not abs(e_tz - JAX_H2_TZ_OPTORB_F64) <= H2_TZ_OPTORB_TOL:
        failed.append(f"H2 cc-pVTZ E {e_tz!r} not within {H2_TZ_OPTORB_TOL}"
                      f" of the JAX package's {JAX_H2_TZ_OPTORB_F64}")
    emit("optorb_h2", problem="H2 6-31G -> 4 (the class-based family) and "
         "H2 cc-pVTZ -> 4 (OptOrbVQE), f64", card=card, cpu=cpu,
         anchors=anchors, tolerance=[1e-8, H2_ANCHOR_TOL], card_s=card_s,
         h2_cc_pvtz=e_tz, h2_cc_pvtz_jax_f64=JAX_H2_TZ_OPTORB_F64,
         h2_cc_pvtz_published=PUBLISHED_H2_TZ, h2_cc_pvtz_s=tz_s,
         gates_failed=failed)
    if failed:
        raise AssertionError("optorb H2 gates failed: " + "; ".join(failed))
    return launches, E


def _n2_casscf(basis: str, n_act: int, kw: dict, route: str):
    """N2 at `basis` (RHF, the automatic frozen core) and
    FusedOptOrbCASSCF(2 n_act) on it at float32, with the launch counts
    zeroed just before the solve and read just after; then the gates
    every CASSCF solve meets, `route` being the transform's route."""
    import torch
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    t0 = time.perf_counter()
    full = MoleculeDriver(atom=N2_GEOM, basis=basis).run()
    problem = full.active_space()
    chem_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = _casscf_solver(problem, n_act, torch.float32, "cuda", **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held_bytes = torch.cuda.memory_allocated()  # earlier phases' too
    gemm.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solver.compute_minimum_energy()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = gemm.launch_counts()
    routes = gemm.route_launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    U = torch.as_tensor(r.optimal_partial_unitary, device=solver.device)
    vals = solver._sector.build_values(*K.expand_spin_tensors(
        K.rotate_one_body(solver._h_sp, U), K.rotate_two_body(solver._g_sp, U)),
        solver._sector_tables)
    witness = _casscf_f64_witness(problem, solver, r, vals)
    failed = _casscf_gates(r, witness, launches, routes, route)
    rhf = full.scf.energy_electronic + full.nuclear_repulsion_energy
    total = r.eigenvalue + problem.core_energy + problem.nuclear_repulsion_energy
    rec = dict(m=problem.num_spatial_orbitals, n=n_act,
               num_particles=list(problem.num_particles),
               determinants=solver._sector.dim, rhf_total=rhf,
               energy=r.eigenvalue, energy_total=total,
               core_energy=problem.core_energy, settings=kw,
               outer_iterations=r.outer_iterations,
               outer_trace=r.energy_convergence_list,
               stage_stats=r.stage_stats, chem_s=chem_s, setup_s=setup_s,
               solve_s=solve_s, eri_engine=problem.eri_engine,
               peak_memory_bytes=peak_bytes,
               held_before_solve_bytes=held_bytes, launches=launches,
               transform_route_launches=routes, f64_witness=witness)
    return full, problem, r, rec, launches, failed


def phase_chem() -> dict:
    """N2 past hydrogen, the chemistry ported whole: cc-pVDZ 26 -> 16 spin
    orbitals (the JAX package's showcase; the one-pass transform at
    (26, 8)) and cc-pVTZ 58 -> 20 (the K1 chain at (58, 10)), each RHF
    with the two N 1s cores frozen, FusedOptOrbCASSCF at float32; then
    the dipole, quadrupole and Mulliken populations of the cc-pVDZ solve
    from its 1-RDM on the host."""
    from esoo_torch.chem import (dipole_moment, populations,
                                 quadrupole_moment)
    paths = {}
    full, act, r, rec, paths["casscf_n2_dz"], failed = _n2_casscf(
        "cc-pvdz", 8, N2_CASSCF_KW, "fused")
    occ = sorted((float(o) for o in r.natural_occupations), reverse=True)
    g, U = r.one_rdm_spatial, r.optimal_partial_unitary
    mu = dipole_moment(act, g, U)
    quad = quadrupole_moment(act, g, U)
    pops, charges = populations(act, g, U)
    if not abs(rec["rhf_total"] - N2_DZ_RHF) <= N2_DZ_RHF_TOL:
        failed.append(f"RHF total {rec['rhf_total']!r} not within "
                      f"{N2_DZ_RHF_TOL} of {N2_DZ_RHF}")
    if not (act.num_particles == (5, 5) and act.num_spatial_orbitals == 26):
        failed.append(f"active space {act.num_particles} in "
                      f"{act.num_spatial_orbitals} orbitals, not (5, 5) in "
                      f"26")
    if not abs(rec["energy_total"] - N2_DZ_CASSCF) <= N2_TOL:
        failed.append(f"CASSCF total {rec['energy_total']!r} not within "
                      f"{N2_TOL} of {N2_DZ_CASSCF}")
    if not (occ[0] > 1.98 and occ[4] < 1.97 and sum(occ[5:8]) > 0.05):
        failed.append(f"natural occupations {occ}")
    if not (float(abs(mu).max()) < 1e-4
            and abs(float(pops.sum()) - 14.0) <= 1e-4):
        failed.append(f"dipole {mu.tolist()} (|mu| < 1e-4 by symmetry), "
                      f"populations summing to {float(pops.sum())!r} (14)")
    emit("chem", path="casscf_n2_dz", problem="N2 cc-pVDZ, RHF, 2 frozen "
         "1s cores, m=26 -> 16 spin orbitals, (5, 5) electrons, f32",
         **rec, gates=[N2_DZ_RHF, N2_DZ_RHF_TOL, N2_DZ_CASSCF, N2_TOL],
         natural_occupations=occ, dipole_au=mu.tolist(),
         quadrupole_au=quad.tolist(), mulliken_populations=pops.tolist(),
         mulliken_charges=charges.tolist(), gates_failed=failed)
    if failed:
        raise AssertionError("N2 cc-pVDZ gates failed: " + "; ".join(failed))

    full, act, r, rec, paths["casscf_n2_tz"], failed = _n2_casscf(
        "cc-pvtz", 10, N2_TZ_KW, "chain")
    if not abs(rec["rhf_total"] - N2_TZ_RHF) <= N2_TOL:
        failed.append(f"RHF total {rec['rhf_total']!r} not within {N2_TOL} "
                      f"of {N2_TZ_RHF}")
    if not (act.num_particles == (5, 5) and act.num_spatial_orbitals == 58
            and rec["determinants"] == 252 ** 2):
        failed.append(f"active space {act.num_particles} in "
                      f"{act.num_spatial_orbitals} orbitals, "
                      f"{rec['determinants']} determinants")
    if not abs(r.eigenvalue - JAX_N2_TZ_20_F64) <= N2_TOL:
        failed.append(f"energy {r.eigenvalue!r} not within {N2_TOL} of the "
                      f"JAX package's float64 {JAX_N2_TZ_20_F64}")
    if rec["eri_engine"] != "native":      # f shells: C++, not Python
        failed.append(f"ERI engine {rec['eri_engine']!r}, not the native "
                      f"C++ engine")
    emit("chem", path="casscf_n2_tz", problem="N2 cc-pVTZ, RHF, 2 frozen "
         "1s cores, m=58 -> 20 spin orbitals, (5, 5) electrons, 63,504 "
         "determinants, f32", **rec, gates=[N2_TZ_RHF, JAX_N2_TZ_20_F64,
                                            N2_TOL], gates_failed=failed)
    if failed:
        raise AssertionError("N2 cc-pVTZ gates failed: " + "; ".join(failed))
    return paths


def _relative_err(out, ref) -> float:
    """max|out - ref| / max(1, max|ref|), float64 on the host."""
    out, ref = out.detach().double().cpu(), ref.detach().double().cpu()
    return float((out - ref).abs().max()) / max(1.0,
                                                float(ref.abs().max()))


def phase_pairs(problem) -> dict:
    """The pairwise sector kernels (SectorUCC kernel 'pairs', the string
    kernels' oracle) on the card.  (a) FusedOptOrbVQE on H8 cc-pVTZ -> 12
    (the `full` phase's settings, f32) with ESOO_SECTOR_KERNEL=pairs, the
    launch counts zeroed just before the solve and read just after;
    gates: E within PAIRS_TOL of JAX_H8_12_FULL_F64 and of the same
    solver on the string kernel, solved in the phase, and every transform
    launch one-pass.  One L-BFGS evaluation's wall, device ms and launches
    on each kernel, and the busy share over a one-outer-iteration solve.
    (b) The oracle at full width, float64: H8 cc-pVTZ -> 16 (4,900
    determinants, UCCSD with 360 parameters) at the integrals rotated by
    a seeded partial unitary, pairs against strings at seeded theta
    (state, energy and its theta-gradient, gamma and Gamma within
    PAIRS_ORACLE_TOL relative), and the lowest eigenvalue of the dense
    build_hamiltonian within 1e-8 of davidson_ground on SectorCI; the
    Slater-Condon structure scan's host time cold and from its disk
    cache."""
    import os
    import shutil

    import numpy as np
    import torch
    import esoo_torch as T
    from esoo_torch.initializations.ci import enumerate_determinants
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.stiefel import value_and_grad
    from esoo_torch.sim import SectorCI
    from esoo_torch.sim import sector as S
    from esoo_torch.solvers import davidson_ground
    f32, f64, dev = torch.float32, torch.float64, "cuda"

    def pairs_solver(**kw):
        os.environ["ESOO_SECTOR_KERNEL"] = "pairs"
        try:
            return _full_solver(problem, "sector", f32, dev, **kw)
        finally:
            del os.environ["ESOO_SECTOR_KERNEL"]

    t0 = time.perf_counter()
    solver = pairs_solver(**H8_FULL_KW)
    setup_s = time.perf_counter() - t0
    sec = solver._sector
    held_bytes = torch.cuda.memory_allocated()   # earlier phases' too
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
    E, stats = r.eigenvalue, r.stage_stats

    strings = _full_solver(problem, "sector", f32, dev, **H8_FULL_KW)
    t0 = time.perf_counter()
    r_str = strings.compute_minimum_energy()
    torch.cuda.synchronize()
    strings_solve_s = time.perf_counter() - t0

    # one L-BFGS evaluation at the final state on each kernel
    U = torch.as_tensor(r.optimal_partial_unitary, device=dev)
    theta = torch.as_tensor(r.optimal_point, device=dev)
    h_so, g_so = K.expand_spin_tensors(*solver._rotate(U))
    evaluation = {}
    for name, s in (("pairs", sec), ("strings", strings._sector)):
        vals = s.build_values(h_so, g_so)
        vag = value_and_grad(s.energy_values)
        vag(theta, vals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            vag(theta, vals)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 10 * 1e3
        dms, events = device_profile(lambda: vag(theta, vals), reps=3)
        evaluation[name] = dict(wall_ms=wall_ms, device_ms=dms,
                                device_events=events)
    window_s, busy_s = busy_share(pairs_solver(maxiter=1)
                                  .compute_minimum_energy)

    failed = []
    if sec.kernel != "pairs" or strings._sector.kernel != "strings":
        failed.append(f"kernels {sec.kernel}, {strings._sector.kernel}")
    if not abs(E - JAX_H8_12_FULL_F64) <= PAIRS_TOL:
        failed.append(f"(a) energy {E!r} not within {PAIRS_TOL} of the JAX "
                      f"package's float64 {JAX_H8_12_FULL_F64}")
    if not abs(E - r_str.eigenvalue) <= PAIRS_TOL:
        failed.append(f"(a) energy {E!r} not within {PAIRS_TOL} of the "
                      f"string kernel's {r_str.eigenvalue!r}")
    if not (launches["gemm.rotate_two_body_cuda"] > 0
            and launches["gemm.matmul"] == 0 and routes["chain"] == 0):
        failed.append(f"(a) launches {launches}, routes {routes}: the "
                      f"one-pass transform only")
    solves = r.outer_iterations + 1
    emit("pairs", problem="H8 cc-pVTZ m=112 -> 12 spin orbitals, (4, 4) "
         "electrons, UCCSD(6, (4, 4)) from HF (92 parameters, 225 "
         "determinants), ESOO_SECTOR_KERNEL=pairs, f32, maxiter 10, tol "
         "1e-5", energy=E, strings_energy=r_str.eigenvalue,
         jax_f64=JAX_H8_12_FULL_F64, tolerance=PAIRS_TOL,
         outer_trace=r.energy_convergence_list,
         outer_iterations=r.outer_iterations, setup_s=setup_s,
         solve_s=solve_s, strings_solve_s=strings_solve_s,
         strings_outer_iterations=r_str.outer_iterations,
         peak_memory_bytes=peak_bytes, held_before_solve_bytes=held_bytes,
         stage_stats=stats, lbfgs_evaluations=stats["lbfgs_evaluations"],
         lbfgs_evaluations_per_solve=stats["lbfgs_evaluations"] / solves,
         strings_lbfgs_evaluations=r_str.stage_stats["lbfgs_evaluations"],
         lbfgs_evaluation=evaluation,
         busy_window=dict(maxiter=1, wall_s=window_s, device_busy_s=busy_s,
                          device_busy_share=busy_s / window_s),
         launches=launches, transform_route_launches=routes,
         gates_failed=failed)
    if failed:
        raise AssertionError("pairs gates failed: " + "; ".join(failed))

    # (b) the oracle at H8 -> 16, float64
    n, parts = 8, (4, 4)
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "esoo_torch", "sector_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    saved = os.environ.get("ESOO_CACHE_DIR")
    os.environ["ESOO_CACHE_DIR"] = cache_dir
    try:
        dets = [int(d) for d in enumerate_determinants(2 * n, parts,
                                                       sum(parts))]
        t0 = time.perf_counter()
        S._slater_condon_structure_cached(dets, 2 * n)
        scan_cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        S._slater_condon_structure_cached(dets, 2 * n)
        scan_cached_s = time.perf_counter() - t0
        ansatz = T.UCCSD(n, parts, initial_state=T.HartreeFock(n, parts))
        t0 = time.perf_counter()
        sp = S.SectorUCC(ansatz, 2 * n, kernel="pairs")
        tabs = sp.device_tables(f64, device=dev)
        pairs_tables_s = time.perf_counter() - t0
    finally:
        if saved is None:
            del os.environ["ESOO_CACHE_DIR"]
        else:
            os.environ["ESOO_CACHE_DIR"] = saved
    ss = S.SectorUCC(ansatz, 2 * n, kernel="strings")
    h_np, g_np = (np.ascontiguousarray(a)
                  for a in problem.spatial_integral_tensors())
    U = _partial_unitary(problem.num_spatial_orbitals, n, f64,
                         torch.Generator().manual_seed(16)).to(dev)
    with torch.no_grad():
        h_so, g_so = K.expand_spin_tensors(
            K.rotate_one_body(torch.as_tensor(h_np, device=dev), U),
            K.rotate_two_body(torch.as_tensor(g_np, device=dev), U))
    del g_np
    theta = 0.1 * torch.randn(len(sp._excs), dtype=f64,
                              generator=torch.Generator().manual_seed(7))
    theta = theta.to(dev)
    got = {}
    for name, s in (("pairs", sp), ("strings", ss)):
        vals = s.build_values(h_so, g_so)
        x = theta.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        energy = s.energy_values(x, vals)
        (grad,) = torch.autograd.grad(energy, x)
        torch.cuda.synchronize()
        vag_s = time.perf_counter() - t0
        with torch.no_grad():
            v = s.state(theta)
            got[name] = dict(state=v, energy=energy.detach(), grad=grad,
                             rdms=s.rdms(v), vag_s=vag_s)
    errs = {k: _relative_err(got["pairs"][k], got["strings"][k])
            for k in ("state", "energy", "grad")}
    errs["gamma"], errs["Gamma"] = (
        _relative_err(a, b) for a, b in zip(got["pairs"]["rdms"],
                                            got["strings"]["rdms"]))
    t0 = time.perf_counter()
    H = sp.build_hamiltonian(h_so, g_so)
    lam0 = float(torch.linalg.eigvalsh(H)[0])
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    del H
    ci = SectorCI(2 * n, parts)
    cvals = ci.build_values(h_so, g_so)
    res = davidson_ground(
        lambda v: ci.sigma_values(v.reshape(ci.nB, ci.nA), cvals).reshape(-1),
        ci.diagonal_values(cvals).reshape(-1),
        ci.hf_matrix(f64, device=dev).reshape(-1), tol=1e-10)
    failed = [f"{k}: {e:.3e} > {PAIRS_ORACLE_TOL}" for k, e in errs.items()
              if not e <= PAIRS_ORACLE_TOL]
    if not abs(lam0 - float(res.eigenvalue)) <= 1e-8:
        failed.append(f"dense lowest eigenvalue {lam0!r} vs SectorCI "
                      f"Davidson {float(res.eigenvalue)!r}")
    emit("pairs_oracle", problem="H8 cc-pVTZ m=112 -> 16 spin orbitals, "
         "(4, 4) electrons, 4,900 determinants, UCCSD(8, (4, 4)) from HF "
         "(360 parameters), f64, integrals rotated by a seeded partial "
         "unitary, theta seeded (0.1 N(0, 1))", determinants=sp.dim,
         parameters=len(sp._excs), relative_errors=errs,
         tolerance=PAIRS_ORACLE_TOL, energy=float(got["pairs"]["energy"]),
         dense_lowest=lam0, sector_ci_davidson=float(res.eigenvalue),
         sector_ci_residual=float(res.residual_norm),
         structure_scan_cold_s=scan_cold_s,
         structure_scan_cached_s=scan_cached_s,
         pairs_tables_s=pairs_tables_s, dense_build_eigvalsh_s=dense_s,
         pairs_vag_s=got["pairs"]["vag_s"],
         strings_vag_s=got["strings"]["vag_s"],
         row_width=int(tabs["VIDX"].shape[1]), gates_failed=failed)
    if failed:
        raise AssertionError("pairs oracle gates failed: "
                             + "; ".join(failed))
    return launches


def phase_mesh(problem, casscf: dict, h4, optorb_energy: float) -> dict:
    """The orbital mesh over the integral tensor.  (a) FusedOptOrbCASSCF
    on H8 cc-pVTZ -> 28 (the casscf phase's settings) with g sharded over
    a 4-shard mesh: four logical shards on cuda:0, or the first four
    cards where the machine has them; the launch counts zeroed just
    before the solve and read just after.  Gates: every gate of the
    casscf phase (on the shard route: 16 K1 launches a rotation); the
    first outer energy within MESH_TOL of the unsharded solve's (the
    same U0: the sharded rotation against the unsharded one); and at the
    unsharded solve's final U and RDMs, the sharded rotation and the
    sharded BB objective's value and gradient against the unsharded ones
    at the kernels' float32 tolerance.  The final E is printed beside
    the unsharded E, not gated against it: from the first BB descent on,
    float32 trajectories of different summation orders part by up to
    ~1.5e-3 on this surface's plateau (the casscf phase's window against
    the JAX package's float32 energy is 1e-3 for the same reason).
    (b) FusedOptOrbVQE and the class-based OptOrbVQE on H4 cc-pVTZ -> 8
    at float64 on a 4-shard mesh, each within MESH_F64_TOL of its
    unsharded run (the optorb phase's, for the class-based one)."""
    import numpy as np
    import torch
    from esoo_torch.ops import gemm
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.fused import _ORBITAL_VAG
    from esoo_torch.orbital_optimization.stiefel import value_and_grad
    from esoo_torch.parallel import (make_orbital_mesh,
                                     rotate_two_body_sharded,
                                     sharded_spatial_energy)
    f32, f64, dev = torch.float32, torch.float64, "cuda"
    devices = ([f"cuda:{i}" for i in range(4)]
               if torch.cuda.device_count() >= 4 else ["cuda:0"] * 4)
    mesh = make_orbital_mesh(devices=devices)
    t0 = time.perf_counter()
    solver = _casscf_solver(problem, 14, f32, dev, maxiter=10,
                            stopping_tolerance=1e-5, dispatch="two",
                            mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held_bytes = torch.cuda.memory_allocated()   # earlier phases' too
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
    E, stats = r.eigenvalue, r.stage_stats

    sec, tabs = solver._sector, solver._sector_tables
    U = torch.as_tensor(r.optimal_partial_unitary, device=dev)
    vals = sec.build_values(*K.expand_spin_tensors(*solver._rotate(U)), tabs)
    witness = _casscf_f64_witness(problem, solver, r, vals)

    # the sharded rotation and BB objective at the unsharded solve's final
    # U and RDMs against the unsharded ones (g whole on the card for this)
    U0 = torch.as_tensor(casscf["U"], device=dev)
    V0 = torch.as_tensor(casscf["V"], device=dev).reshape(sec.nB, sec.nA)
    gamma_s, Gamma_s = K.spin_reduce_rdms(*sec.rdms(V0, tabs))
    g_whole = torch.as_tensor(np.ascontiguousarray(
        problem.spatial_integral_tensors()[1]), device=dev).to(f32)
    E_u, G_u = _ORBITAL_VAG(U0, gamma_s, Gamma_s, solver._h_sp, g_whole)
    rot_u = K.rotate_two_body(g_whole, U0)
    del g_whole
    E_m, G_m = value_and_grad(sharded_spatial_energy(mesh))(
        U0, gamma_s, Gamma_s, solver._h_sp, solver._g_shards)
    gemm.reset_launch_counts()
    rot_m = rotate_two_body_sharded(mesh, solver._g_shards, U0)
    torch.cuda.synchronize()
    at_u = dict(
        rotation_err=check_close(rot_m, rot_u, f32, "sharded rotation"),
        energy_err=check_close(E_m, E_u, f32, "sharded objective"),
        gradient_err=check_close(G_m, G_u, f32, "sharded gradient"),
        rotation_launches=gemm.route_launch_counts())
    failed = []
    if not abs(E - H8_CASSCF_REFERENCE) <= H8_CASSCF_TOL:
        failed.append(f"energy {E!r} not within {H8_CASSCF_TOL} of "
                      f"{H8_CASSCF_REFERENCE}")
    first = r.energy_convergence_list[0]
    if not abs(first - casscf["first"]) <= MESH_TOL:
        failed.append(f"first outer energy {first!r} not within {MESH_TOL} "
                      f"of the unsharded {casscf['first']!r}")
    if at_u["rotation_launches"]["shard"] != 16:
        failed.append(f"the sharded rotation's launches "
                      f"{at_u['rotation_launches']}")
    failed += _casscf_gates(r, witness, launches, routes, "shard", 4)
    emit("mesh", problem="H8 cc-pVTZ m=112 -> 28 spin orbitals, "
         "FusedOptOrbCASSCF as in the casscf phase, g sharded on its last "
         "axis over a 4-shard mesh (m_loc = 28)", devices=devices,
         energy=E, unsharded_energy=casscf["energy"],
         unsharded_first_outer=casscf["first"],
         tolerance=[H8_CASSCF_TOL, MESH_TOL, "f32 5e-6*max(1,max|ref|)"],
         at_unsharded_optimum=at_u,
         outer_trace=r.energy_convergence_list,
         outer_iterations=r.outer_iterations, setup_s=setup_s,
         solve_s=solve_s, unsharded_solve_s=casscf["solve_s"],
         bb_s=stats["bb_s"], unsharded_bb_s=casscf["bb_s"],
         bb_iterations=stats["bb_iterations"],
         peak_memory_bytes=peak_bytes, held_before_solve_bytes=held_bytes,
         unsharded_peak_memory_bytes=casscf["peak_memory_bytes"],
         launches=launches, transform_route_launches=routes,
         f64_witness=witness, gates_failed=failed)
    if failed:
        raise AssertionError("mesh gates failed: " + "; ".join(failed))

    # (b) H4 cc-pVTZ -> 8 at float64 on a 4-shard mesh
    import esoo_torch as T

    def fused(mesh=None):
        return T.FusedOptOrbVQE(
            num_spin_orbitals=8, ansatz=T.UCCSD(
                4, (2, 2), initial_state=T.HartreeFock(4, (2, 2))),
            problem=h4, maxiter=20, stopping_tolerance=1e-5, dtype=f64,
            device=dev, mesh=mesh).compute_minimum_energy()

    t0 = time.perf_counter()
    e_fused = fused().eigenvalue
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_fused_mesh = fused(mesh).eigenvalue
    fused_mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_class_mesh = float(_class_optorbvqe(h4, 4, dev, mesh=mesh)
                         .compute_minimum_energy().eigenvalue)
    class_mesh_s = time.perf_counter() - t0
    failed = []
    if not abs(e_fused_mesh - e_fused) <= MESH_F64_TOL:
        failed.append(f"FusedOptOrbVQE {e_fused_mesh!r} vs unsharded "
                      f"{e_fused!r}")
    if not abs(e_class_mesh - optorb_energy) <= MESH_F64_TOL:
        failed.append(f"OptOrbVQE {e_class_mesh!r} vs unsharded "
                      f"{optorb_energy!r}")
    emit("mesh_h4", problem="H4 cc-pVTZ m=56 -> 8 spin orbitals, f64, "
         "g over a 4-shard mesh (m_loc = 14): FusedOptOrbVQE (UCCSD from "
         "HF, maxiter 20) and the class-based OptOrbVQE (the optorb "
         "phase's)", devices=devices, fused=e_fused,
         fused_mesh=e_fused_mesh, class_unsharded=optorb_energy,
         class_mesh=e_class_mesh, tolerance=MESH_F64_TOL, fused_s=fused_s,
         fused_mesh_s=fused_mesh_s, class_mesh_s=class_mesh_s,
         gates_failed=failed)
    if failed:
        raise AssertionError("mesh H4 gates failed: " + "; ".join(failed))
    return launches


def mesh_only() -> int:
    """`python3 chip_smoke.py --mesh-only`: the kernels' build, the
    unsharded casscf phase, the optorb phase's class-based H4 solve and
    the mesh phases alone, for a machine of four cards (whose mesh the
    mesh phase takes: each shard's K1 launches on its own card, the
    partials summed by torch.cuda.comm.reduce_add).  Prints the phases'
    lines, the card line and `{"ok": true, ...}` last; a run with no
    arguments drives every path."""
    import torch
    from esoo_torch.chem import MoleculeDriver
    card = phase_device()
    _, h8, casscf = phase_casscf()
    h4 = MoleculeDriver(atom=H4_GEOM, basis="cc-pvtz").run()
    optorb_energy = float(_class_optorbvqe(h4, 4, "cuda")
                          .compute_minimum_energy().eigenvalue)
    phase_mesh(h8, casscf, h4, optorb_energy)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import esoo_torch  # noqa: F401  (fails outside a checkout of the repo)
    if sys.argv[1:] == ["--mesh-only"]:
        return mesh_only()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = phase_device()
    timed = phase_kernels(card)
    paths = {}
    paths["vqe_h4"], problem = phase_main_path()
    phase_profile(problem)
    paths["ssvqe_h4"] = phase_excited(problem)
    h4 = problem
    paths["casscf_h8_n28"], h8, casscf = phase_casscf()
    paths["casscf_h8_n32_compact"] = phase_compact(h8)
    paths["vqe_full_h8_n12"] = phase_full(h8)
    phase_parity()
    paths["optorbvqe_h4"], optorb_energy = phase_optorb(h4)
    paths.update(phase_chem())
    paths["vqe_pairs_h8_n12"] = phase_pairs(h8)
    paths["casscf_h8_n28_mesh4"] = phase_mesh(h8, casscf, h4, optorb_energy)
    del h8, h4

    table = []
    # K2's source is the one-pass kernel for n <= 8 (the VQE and SSVQE
    # paths'); n > 8 keeps the four-launch chain of gemm.cu
    sources = {"gemm.matmul": ("esoo_tpu/ops/pallas_kernels.py:58",
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
