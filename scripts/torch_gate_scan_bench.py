"""The string gate scan's paths end to end on one NVIDIA GPU: the H4 main
path and the H8 -> 16 scale demo, with their L-BFGS evaluations.

    python3 scripts/torch_gate_scan_bench.py [--root CHECKOUT] [--tag NAME]
                                             [--h8-cache FILE] [--out DIR]

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
and for each, at the solve's final state, one L-BFGS evaluation (value
and gradient of the sector energy): its wall (host clock over 5,
synchronized), device ms and device events a call (torch.profiler, 3
calls), the gate scan kernels' launches a call (0 where the checkout has
none), and the busy share over 3 evaluations.
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


def _evaluation(C, vag, theta, vals) -> dict:
    import torch
    try:
        from esoo_torch.ops import gate_scan
    except ImportError:                    # a checkout before the kernels
        gate_scan = None
    vag(theta, vals)
    torch.cuda.synchronize()
    if gate_scan is not None:
        gate_scan.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        vag(theta, vals)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    scan = 0 if gate_scan is None else \
        gate_scan.launch_counts()["gate_scan.apply_rev_str"] / 5
    device_ms, events = C.device_profile(lambda: vag(theta, vals), reps=3)
    window_s, busy_s = C.busy_share(
        lambda: [vag(theta, vals) for _ in range(3)])
    return dict(evaluation_wall_ms=wall_ms, evaluation_device_ms=device_ms,
                evaluation_device_events=events,
                evaluation_gate_scan_launches=scan,
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


def h8_16(C, root: str, cache: str) -> dict:
    import torch
    from esoo_torch.chem import MoleculeDriver
    if cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            problem = pickle.load(f)
    else:
        problem = MoleculeDriver(atom=C.H8_GEOM, basis="cc-pvtz").run()
        if cache:
            with open(cache, "wb") as f:
                pickle.dump(problem, f)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--h8-cache", default="")
    ap.add_argument("--out", default=os.path.join(HERE, "build"))
    args = ap.parse_args()
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
    rec = {"tag": args.tag, "root": args.root, "card": card,
           "h4": h4(C), "h8_16": h8_16(C, root, args.h8_cache)}
    line = json.dumps(rec)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"gate_scan_bench_{args.tag}.json"),
              "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
