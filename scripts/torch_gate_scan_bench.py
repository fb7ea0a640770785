"""The gate scans' paths end to end on one NVIDIA GPU: the string scan's
H4 main path and H8 -> 16 scale demo, and the H8 -> 12 paths of the
full-space Pauli-rotation scan and of the pairs scan, with their L-BFGS
evaluations.

    python3 scripts/torch_gate_scan_bench.py [--root CHECKOUT] [--tag NAME]
                                             [--h8-cache FILE] [--out DIR]
                                             [--paths h4,h8_16,full,pairs,
                                                      kernels]

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
kernel's launches a call (the wrappers the checkout has), and the busy
share over 3 evaluations.  The default --paths is h4,h8_16.
  * kernels: the string gate scan's and the Pauli-rotation scan's kernel
    rows, each at its shapes (GATE_SCAN_SHAPES, PROT_SCAN_SHAPES) as the
    kernels phase of the checkout's own chip_smoke.py holds and times
    them (its wrappers' calls match its own kernels): each row's time a
    direction (CUDA events and the profiler's kernel time), bound and
    max_abs_err.
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


def _scan_wrappers() -> list:
    """The scan kernel wrappers of the checkout under test (a checkout
    before a kernel lacks its module)."""
    import importlib
    out = []
    for name in ("gate_scan", "prot_scan", "pair_scan"):
        try:
            out.append(importlib.import_module(f"esoo_torch.ops.{name}"))
        except ImportError:
            pass
    return out


def _evaluation(C, vag, *args) -> dict:
    import torch
    wrappers = _scan_wrappers()
    vag(*args)
    torch.cuda.synchronize()
    for w in wrappers:
        w.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        vag(*args)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    scans = {k: v / 5 for w in wrappers for k, v in w.launch_counts().items()}
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


_ROW_KEYS = ("shape", "routes", "ms", "fwd_ms", "bwd_ms", "fwd_kernel_ms",
             "bwd_kernel_ms", "bound_ms", "bound_by", "max_abs_err",
             "plain_kernel_ms", "groups", "window", "ring_stages")


def kernels(root: str) -> dict:
    """The K3 and K8 rows of the kernels phase of `root`'s chip_smoke.py
    (loaded under another name beside this checkout's), their timing
    fields."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(root, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    peak = S.peaks(S.nvidia_smi())
    checks = []
    rows = {"gate_scan": S._gate_scan_kernels(checks, peak),
            "prot_scan": S._prot_scan_kernels(checks, peak)}
    return {kernel: {name: {k: v for k, v in row.items() if k in _ROW_KEYS}
                     for name, row in shapes.items()}
            for kernel, shapes in rows.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--h8-cache", default="")
    ap.add_argument("--out", default=os.path.join(HERE, "build"))
    ap.add_argument("--paths", default="h4,h8_16")
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
    h8 = _h8(C, args.h8_cache) if set(paths) - {"h4", "kernels"} \
        else None
    runs = {"h4": lambda: h4(C), "h8_16": lambda: h8_16(C, root, h8),
            "full": lambda: full(C, h8), "pairs": lambda: pairs(C, h8),
            "kernels": lambda: kernels(root)}
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
