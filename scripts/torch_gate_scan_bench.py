"""The gate scans' paths end to end on one NVIDIA GPU: the string scan's
H4 main path and H8 -> 16 scale demo, and the H8 -> 12 paths of the
full-space Pauli-rotation scan and of the pairs scan, with their L-BFGS
evaluations.

    python3 scripts/torch_gate_scan_bench.py [--root CHECKOUT] [--tag NAME]
                                             [--h8-cache FILE] [--out DIR]
                                             [--paths h4,h8_16,full,pairs,
                                                      kernels,blocks,starts]
                                             [--rows gate_scan,prot_scan,
                                                     pair_scan]

--root runs the esoo_torch package (and examples/) of another checkout,
so that two versions are compared in one call on one card (run parent,
change, change, parent); the timing helpers are this checkout's
chip_smoke.py.  --h8-cache pickles the H8 cc-pVTZ problem on the first
run and loads it on the next (the integrals are host work, the same in
every version).  Prints one JSON line and writes it to
DIR/gate_scan_bench_<tag>.json (DIR: build/ of this checkout unless
given).

Per path:
  * h4: FusedOptOrbVQE on H4 cc-pVTZ m=56 -> 8 spin orbitals, UCCSD (26
    parameters), float32, chip_smoke.py's settings: the cold and the warm
    solve's wall, the warm solve's device busy share (torch.profiler);
  * h8_16: examples/torch_H8_scale_demo.py --maxiter 1 (H8 cc-pVTZ
    m=112 -> 16, UCCSD with 360 parameters, 4,900 determinants, float32):
    its solve_s and energy;
  * full: FusedOptOrbVQE(simulation='full') on H8 cc-pVTZ m=112 -> 12
    (640 Pauli rotations on 4,096 amplitudes, float32, chip_smoke.py's
    full phase settings): the solve's wall, energy and evaluations;
  * pairs: the same on the sector with ESOO_SECTOR_KERNEL=pairs (225
    determinants, 92 gates);
and for each, at the solve's final state, one L-BFGS evaluation (value
and gradient of the energy): its wall (host clock over 5, synchronized),
device ms and device events a call (torch.profiler, 3 calls), each scan
kernel's launches a call (ops/_build.py's count, by kernel and route),
and the busy share over 3 evaluations.  The default --paths is h4,h8_16.
  * kernels: the string gate scan's, the Pauli-rotation scan's and the
    pairs scan's kernel rows, each at its shapes (GATE_SCAN_SHAPES,
    PROT_SCAN_SHAPES, PAIR_SCAN_SHAPES) as the kernels phase of the
    checkout's own chip_smoke.py holds and times them (its wrappers'
    calls match its own kernels): each row's time a direction (CUDA
    events and the profiler's kernel time), bound and max_abs_err.
  * blocks: the pairs scan at the H8 -> 12 pairs path's sector (92
    gates of 15 to 60 pairs, one state) at one warp, two and four warps
    (the block size forced through the kernels' C entries, each result's
    largest difference from the plan's), float32 and float64, and at the
    plan's block size its 92 gates emptied (PARTNER the identity, SFIELD
    0) and its first gate alone: each direction's time (CUDA events,
    chip_smoke.time_ms) and the forward's kernel time (profiler).
  * starts: the L-BFGS evaluation counts of the H4 solve (h4's settings)
    and of the H8 -> 16 demo (one outer iteration, the example's
    settings) from the Hartree-Fock point (theta = 0) and from
    STARTS - 1 seeded points (theta = 0.05 N(0, 1), numpy seeds 1, 2,
    ...): each solve's evaluations, their sum and the energy, and the
    active-space integrals at the initial orbitals (h, g, float64 of the
    float32 rotation) for a reference run of the same first solve
    (scripts/k3_dtheta_order.py --jax-counts).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import runpy
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _evaluation(C, vag, *args) -> dict:
    import torch
    from esoo_torch.ops import launch_counts, reset_launch_counts
    vag(*args)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        vag(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    scans = {k: v / 5 for k, v in launch_counts().items()
             if k.split(".")[0] in ("gate_scan", "prot_scan", "pair_scan")}
    device_ms, events = C.device_profile(lambda: vag(*args), reps=3)
    window_s, busy_s = C.busy_share(lambda: [vag(*args) for _ in range(3)])
    return dict(evaluation_wall_ms=wall_ms, evaluation_device_ms=device_ms,
                evaluation_device_events=events,
                evaluation_scan_launches=scans,
                evaluations_busy_share=busy_s / window_s)


def _at_final_state(C, solver, r) -> dict:
    import torch
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.stiefel import value_and_grad
    sec = solver._sector
    U = torch.as_tensor(r.optimal_partial_unitary, device="cuda")
    theta = torch.as_tensor(r.optimal_point, device="cuda")
    vals = sec.build_values(*K.expand_spin_tensors(*solver._rotate(U)))
    return _evaluation(C, value_and_grad(sec.energy_values), theta, vals)


def h4(C) -> dict:
    import torch
    from esoo_torch.chem import MoleculeDriver
    problem = MoleculeDriver(atom=C.H4_GEOM, basis="cc-pvtz").run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C._solver(problem, 4, torch.float32, "cuda").compute_minimum_energy()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    solver = C._solver(problem, 4, torch.float32, "cuda")
    out = {}
    warm_s, busy_s = C.busy_share(
        lambda: out.setdefault("r", solver.compute_minimum_energy()))
    r = out["r"]
    return dict(energy=r.eigenvalue, cold_s=cold_s, warm_s=warm_s,
                warm_busy_share=busy_s / warm_s,
                lbfgs_evaluations=r.stage_stats["lbfgs_evaluations"],
                **_at_final_state(C, solver, r))


def _h8(C, cache: str):
    """The H8 cc-pVTZ problem, pickled to `cache` on the first run and
    loaded on the next."""
    from esoo_torch.chem import MoleculeDriver
    if cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)
    problem = MoleculeDriver(atom=C.H8_GEOM, basis="cc-pvtz").run()
    if cache:
        with open(cache, "wb") as f:
            pickle.dump(problem, f)
    return problem


def _h8_12(C, problem, simulation: str) -> dict:
    """chip_smoke.py's full or pairs phase solve (H8 cc-pVTZ -> 12, f32,
    maxiter 10), then one L-BFGS evaluation at its final state."""
    import torch
    from esoo_torch.orbital_optimization import kernels as K
    from esoo_torch.orbital_optimization.stiefel import value_and_grad
    from esoo_torch.sim.rdm import rdm_energy
    f32 = torch.float32
    solver = C._full_solver(problem, simulation, f32, "cuda",
                            **C.H8_FULL_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = solver.compute_minimum_energy()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    U = torch.as_tensor(r.optimal_partial_unitary, device="cuda")
    theta = torch.as_tensor(r.optimal_point, device="cuda")
    h_so, g_so = K.expand_spin_tensors(*solver._rotate(U))
    if simulation == "full":
        ev = _evaluation(C, value_and_grad(lambda th: rdm_energy(
            solver._compiled.state_fn(th, f32), h_so, g_so)), theta)
    else:
        sec = solver._sector
        ev = _evaluation(C, value_and_grad(sec.energy_values), theta,
                         sec.build_values(h_so, g_so))
    return dict(energy=r.eigenvalue, solve_s=solve_s,
                outer_iterations=r.outer_iterations,
                lbfgs_evaluations=r.stage_stats["lbfgs_evaluations"],
                lbfgs_s=r.stage_stats["lbfgs_s"],
                bb_s=r.stage_stats["bb_s"], **ev)


def full(C, problem) -> dict:
    return _h8_12(C, problem, "full")


def pairs(C, problem) -> dict:
    os.environ["ESOO_SECTOR_KERNEL"] = "pairs"
    try:
        return _h8_12(C, problem, "sector")
    finally:
        del os.environ["ESOO_SECTOR_KERNEL"]


def h8_16(C, root: str, problem) -> dict:
    import torch
    main = runpy.run_path(os.path.join(root, "examples",
                                       "torch_H8_scale_demo.py"),
                          run_name="torch_H8_scale_demo")["main"]
    torch.cuda.synchronize()
    got = main(["--device", "cuda", "--maxiter", "1"], problem=problem)
    r, solver = got["result"], got["solver"]
    return dict(energy=r.eigenvalue, solve_s=got["solve_s"],
                outer_iterations=r.outer_iterations,
                lbfgs_evaluations=r.stage_stats["lbfgs_evaluations"],
                lbfgs_s=r.stage_stats["lbfgs_s"],
                **_at_final_state(C, solver, r))


STARTS = 6


def starts(C, h8, device: str = "cuda", count: int = STARTS) -> dict:
    """Evaluation counts from `count` starting points (module docstring;
    the H8 -> 16 demo only when its problem `h8` is given)."""
    import numpy as np
    import torch
    import esoo_torch as T
    from esoo_torch.chem import MoleculeDriver
    f32 = torch.float32
    settings = {
        "h4": (MoleculeDriver(atom=C.H4_GEOM, basis="cc-pvtz").run(), 4,
               dict(maxiter=20, stopping_tolerance=1e-5, diagnostics=False)),
        "h8_16": (h8, 8, dict(maxiter=1, stopping_tolerance=1e-4,
                              vqe_maxiter=120))}
    if h8 is None:
        del settings["h8_16"]
    out = {}
    for name, (problem, n, kw) in settings.items():
        parts = problem.num_particles

        def solver(x0):
            ansatz = T.UCCSD(n, parts,
                             initial_state=T.HartreeFock(n, parts))
            return T.FusedOptOrbVQE(
                num_spin_orbitals=2 * n, ansatz=ansatz, problem=problem,
                dtype=f32, device=device, initial_point=x0, **kw)

        first = solver(None)
        P = first.ansatz.num_parameters
        runs = []
        for seed in range(count):
            x0 = np.zeros(P) if seed == 0 else \
                0.05 * np.random.default_rng(seed).normal(size=P)
            sv = solver(x0)
            with C.LbfgsCount() as lbfgs:
                r = sv.compute_minimum_energy()
            runs.append(dict(seed=seed, solves=lbfgs.solves,
                             lbfgs_evaluations=sum(lbfgs.solves),
                             energy=r.eigenvalue))
        h, g = first._rotate(first._U0)
        out[name] = dict(parameters=P, runs=runs,
                         h_act=h.double().cpu().tolist(),
                         g_act=g.double().cpu().reshape(-1).tolist())
    return out


def _at_threads(threads: int, direction: str, v, tensors: list, c, s,
                P, S) -> None:
    """One launch of the pairs scan's C entry at a forced block size,
    otherwise as ops/pair_scan.py::_launch makes it (the wrapper always
    takes the plan's size): `tensors` are the forward's v0, out or the
    backward's v, w, w0, dth."""
    import torch
    from esoo_torch.ops import _build, pair_scan
    B, n = v.shape
    st = pair_scan._stream(P, S)
    ring = pair_scan._plan(n, v.dtype, len(c), st["max_pairs"],
                           st["total"])[direction]
    if direction == "bwd":
        tensors = tensors + [torch.empty_like(v)
                             if ring["route"] == "global" else None]
    _build.launch("pair_scan", f"esoo_pair_scan_{direction}_"
                  f"{_build.TAGS[v.dtype]}", v.device, st["rec"], st["off"],
                  c, s, *tensors, B, len(c), n, ring["log_chunk"],
                  ring["chunks"], ring["stages"],
                  pair_scan._ROUTES.index(ring["route"]), threads,
                  route=ring["route"])


def blocks(C) -> dict:
    """The pairs scan's block sizes at H8 -> 12 (module docstring)."""
    import numpy as np
    import torch
    from esoo_torch.ops import pair_scan
    from esoo_torch.sim import HartreeFock, UCCSD
    from esoo_torch.sim.sector import SectorUCC
    sec = SectorUCC(UCCSD(6, (4, 4), initial_state=HartreeFock(6, (4, 4))),
                    12, kernel="pairs")
    rng = np.random.default_rng(6)
    th = rng.normal(size=len(sec._excs)) * 0.4
    v0 = rng.normal(size=(1, sec.dim + 1))
    v0[:, -1] = 0.0
    ct = rng.normal(size=v0.shape)
    out = {}
    for dt in (torch.float32, torch.float64):
        P = torch.as_tensor(sec._PARTNER, device="cuda")
        S, t, v, w = (torch.as_tensor(a, device="cuda").to(dt)
                      for a in (sec._SFIELD, th, v0, ct))
        c, s = torch.cos(t), torch.sin(t)
        vk = pair_scan._forward(v, c, s, P, S)
        w0, dth = pair_scan._backward(vk, w, c, s, P, S)
        # the block size forced (each held to the plan's result) ...
        for threads in (32, 64, 128):
            fo, bo = torch.empty_like(v), [torch.empty_like(v),
                                           torch.empty_like(dth)]

            def fwd():
                _at_threads(threads, "fwd", v, [v, fo], c, s, P, S)

            def bwd():
                _at_threads(threads, "bwd", vk, [vk, w] + bo, c, s, P, S)

            fwd(), bwd()
            out[f"{str(dt)[6:]}_{threads}"] = dict(
                fwd_ms=C.time_ms(fwd), bwd_ms=C.time_ms(bwd),
                fwd_kernel_ms=C.kernel_ms(fwd, match="pair_scan_fwd"),
                max_abs_diff=max(float((x - y).abs().max()) for x, y in (
                    (fo, vk), (bo[0], w0), (bo[1].sum(0), dth.sum(0)))))
        # ... then, at the plan's, the same 92 gates with no pairs (the
        # loop's own cost a gate) and the first gate alone (the launch's
        # prologue and epilogue)
        empty = (torch.arange(P.shape[1], device="cuda").expand_as(P)
                 .contiguous(), torch.zeros_like(S))
        for name, (PP, SS), cc, ss in (
                ("empty_gates", empty, c, s),
                ("one_gate", (P[:1], S[:1]), c[:1], s[:1])):
            vo = pair_scan._forward(v, cc, ss, PP, SS)
            out[f"{str(dt)[6:]}_{name}"] = dict(
                fwd_ms=C.time_ms(lambda: pair_scan._forward(
                    v, cc, ss, PP, SS)),
                bwd_ms=C.time_ms(lambda: pair_scan._backward(
                    vo, w, cc, ss, PP, SS)),
                fwd_kernel_ms=C.kernel_ms(lambda: pair_scan._forward(
                    v, cc, ss, PP, SS), match="pair_scan_fwd"))
    return out


_ROW_KEYS = ("shape", "routes", "ms", "fwd_ms", "bwd_ms", "fwd_kernel_ms",
             "bwd_kernel_ms", "bound_ms", "bound_by", "max_abs_err",
             "plain_kernel_ms", "groups", "window", "ring_stages", "threads",
             "smem_bytes")


def kernels(root: str, rows: list) -> dict:
    """The scan rows `rows` (of gate_scan, prot_scan, pair_scan) of the
    kernels phase of `root`'s chip_smoke.py (loaded under another name
    beside this checkout's), their timing fields."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    peak = S.peaks(S.nvidia_smi())
    checks = []
    return {row: {name: {k: v for k, v in rec.items() if k in _ROW_KEYS}
                  for name, rec in getattr(S, f"_{row}_kernels")(
                      checks, peak).items()}
            for row in rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--h8-cache", default="")
    ap.add_argument("--out", default=os.path.join(HERE, "build"))
    ap.add_argument("--paths", default="h4,h8_16")
    ap.add_argument("--rows", default="gate_scan,prot_scan,pair_scan",
                    help="the kernels path's rows")
    args = ap.parse_args()
    paths = args.paths.split(",")
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke as C                 # timing helpers of this checkout
    sys.path.insert(0, root)
    for mod in [k for k in sys.modules if k.startswith("esoo_torch")]:
        del sys.modules[mod]
    import torch
    if not torch.cuda.is_available():
        print("torch_gate_scan_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import esoo_torch
    if not esoo_torch.__file__.startswith(root):
        raise AssertionError(f"imported {esoo_torch.__file__}, not {root}")
    card = C.nvidia_smi()
    rec = {"tag": args.tag, "root": args.root, "card": card}
    h8 = _h8(C, args.h8_cache) if set(paths) - {"h4", "kernels", "blocks"} \
        else None
    runs = {"h4": lambda: h4(C), "h8_16": lambda: h8_16(C, root, h8),
            "full": lambda: full(C, h8), "pairs": lambda: pairs(C, h8),
            "kernels": lambda: kernels(root, args.rows.split(",")),
            "starts": lambda: starts(C, h8),
            "blocks": lambda: blocks(C)}
    for name in paths:
        rec[name] = runs[name]()
    line = json.dumps(rec)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"gate_scan_bench_{args.tag}.json"),
              "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
