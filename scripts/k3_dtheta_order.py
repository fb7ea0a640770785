"""The string gate scan K3's float32 dtheta under two fixed summation
orders against float64, on the CPU, and the reference L-BFGS evaluation
counts of the same first solves.

    python3 scripts/k3_dtheta_order.py --starts FILE [--seeds 5]
                                       [--jax-counts] [--port-counts]

FILE is the JSON line of `scripts/torch_gate_scan_bench.py --paths
starts`: for H4 cc-pVTZ -> 8 and the H8 cc-pVTZ -> 16 demo, the
active-space integrals at the initial orbitals (the card's float32
rotation) and the seeded starting points.  Per problem (H4: 26 gates on
(nB, nA) = (6, 6); H8 -> 16: 360 gates on (70, 70)):

  * theta* is the float64 L-BFGS minimum of the sector energy from theta
    = 0 (the port, CPU, gtol 1e-8); the inputs are theta near theta*
    (theta* + 1e-3 N(0, 1)) and near 0 (0.05 N(0, 1)), numpy seeds 1 ..
    --seeds, and the cotangent W = dE/dV at the float64 state;
  * csrc/gate_scan.cu's scan is emulated in float32 (the forward in
    place over each gate's touched pairs, the reversible backward's V
    and W updates, the kernel's block size T) with dtheta summed in two
    fixed orders: "element", the kernel's earlier order (thread t adds
    the terms of elements t, t + T, ... in element order, zeros where the
    gate does not act), and "pair", its current one (thread t adds, for
    each of its pairs p = t, t + T, ..., the term at d and then at r),
    the pairs scan's too; then each warp's
    __shfl_down_sync tree and warp 0's tree over the warp sums.  nvcc's
    FMA contractions are not emulated (torch rounds each product);
  * printed: a gate's relative error |dth32 - dth64| / |dth64| (median
    and maximum over gates with |dth64| >= 1e-3 max|dth64|, and seeds),
    the vector's ||dth32 - dth64|| / ||dth64||, and how far the two
    orders' dtheta are apart in the same measure.

--jax-counts runs the JAX package's lbfgs_minimize at float32 on the CPU
(the fused solver's first solve: SectorUCC.energy_values over
build_values of the same integrals, gtol 1e-5, maxiter = vqe_maxiter)
from the bench's starting points, and --port-counts the port's on the
CPU (its plain scan's order): nfev of each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (n spatial orbitals, particles, the fused solver's vqe_maxiter)
PROBLEMS = {"h4": (4, (2, 2), 200), "h8_16": (8, (4, 4), 120)}


def _integrals(rec: dict, n: int) -> tuple:
    return (np.asarray(rec["h_act"]).reshape(n, n),
            np.asarray(rec["g_act"]).reshape(n, n, n, n))


def _start(seed: int, P: int) -> np.ndarray:
    """The bench's starting point of a seed (torch_gate_scan_bench.starts)."""
    return np.zeros(P) if seed == 0 else \
        0.05 * np.random.default_rng(seed).normal(size=P)


# -- the kernel's schedule in float32 ----------------------------------------

def _pairs(lists, k, nA):
    """Gate k's touched pairs: flat d = (DB[j], DA[i]), r = (QB[j], QA[i])
    for p = j |DA| + i, and fA fB (sigma at r, -sigma at d)."""
    import torch
    nda, ndb = int(lists["NDA"][k]), int(lists["NDB"][k])
    p = torch.arange(nda * ndb)
    j, i = p // nda, p % nda
    da, qa, fa = (torch.as_tensor(lists[key][k, :nda]).long()
                  for key in ("DA", "QA", "FA"))
    db, qb, fb = (torch.as_tensor(lists[key][k, :ndb]).long()
                  for key in ("DB", "QB", "FB"))
    return db[j] * nA + da[i], qb[j] * nA + qa[i], fa[i] * fb[j]


def _warp_tree(x):
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _tree(acc):
    """Per-thread sums (threads,) -> warp trees -> warp 0's tree."""
    import torch
    warps = _warp_tree(acc.reshape(-1, 32))
    lanes = torch.zeros(32, dtype=acc.dtype)
    lanes[:warps.shape[0]] = warps
    return _warp_tree(lanes)


def _strided(x, T):
    """x (n,) as (J, T): thread t's items t, t + T, ... in order."""
    import torch
    J = -(-x.shape[0] // T)
    xs = torch.zeros(J * T, dtype=x.dtype)
    xs[:x.shape[0]] = x
    return xs.reshape(J, T)


def _sum(order, td, tr, ed, er, nd, T):
    """dtheta of one gate from its pairs' terms at d and r."""
    import torch
    acc = torch.zeros(T, dtype=td.dtype)
    if order == "element":
        x = torch.zeros(nd, dtype=td.dtype)
        x[ed], x[er] = td, tr
        for row in _strided(x, T):
            acc = acc + row
    else:
        for a, b in zip(_strided(td, T), _strided(tr, T)):
            acc = acc + a
            acc = acc + b
    return _tree(acc)


def emulate(V0, W, theta, gl, nA, T, orders):
    """The kernel's forward and backward at V0's type: {order: dtheta}
    (the state and W updates are the same in every order)."""
    import torch
    c, s = torch.cos(theta), torch.sin(theta)
    K, nd = theta.shape[0], V0.shape[0]
    pairs = [_pairs(gl, k, nA) for k in range(K)]
    V = V0.clone()
    for k, (ed, er, f) in enumerate(pairs):
        f = f.to(V.dtype)
        cm1, vd, vr = c[k] - 1, V[ed], V[er]
        V[ed] = vd + cm1 * vd + s[k] * (-f * vr)
        V[er] = vr + cm1 * vr + s[k] * (f * vd)
    W = W.clone()
    out = {o: torch.zeros(K, dtype=V.dtype) for o in orders}
    for k in reversed(range(K)):
        ed, er, f = pairs[k]
        f = f.to(V.dtype)
        ck, sk, cm1 = c[k], s[k], c[k] - 1
        sd, sr = -f, f
        vd, vr, wd, wr = V[ed], V[er], W[ed], W[er]
        pd = vd + cm1 * vd - sk * (sd * vr)
        pr = vr + cm1 * vr - sk * (sr * vd)
        td = wd * (-sk * pd + ck * (sd * pr))
        tr = wr * (-sk * pr + ck * (sr * pd))
        for o in orders:
            out[o][k] = _sum(o, td, tr, ed, er, nd, T)
        V[ed], V[er] = pd, pr
        W[ed] = wd + cm1 * wd - sk * (sd * wr)
        W[er] = wr + cm1 * wr - sk * (sr * wd)
    return out


def _errors(got, ref):
    big = np.abs(ref) >= 1e-3 * np.abs(ref).max()
    return (np.abs(got - ref)[big] / np.abs(ref)[big],
            float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))


def dtheta_errors(starts: dict, seeds: int) -> dict:
    import torch
    from esoo_torch.orbital_optimization.kernels import expand_spin_tensors
    from esoo_torch.ops import gate_scan
    from esoo_torch.sim import HartreeFock, UCCSD
    from esoo_torch.sim import strings
    from esoo_torch.sim.sector import SectorUCC
    from esoo_torch.solvers.lbfgs import lbfgs_minimize
    f64 = torch.float64
    out = {}
    for name, (n, parts, _) in PROBLEMS.items():
        if name not in starts:
            continue
        h, g = (torch.as_tensor(a) for a in _integrals(starts[name], n))
        sec = SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                        2 * n)
        vals = sec.build_values(*expand_spin_tensors(h, g))
        K, nA, nd = len(sec._excs), sec.nA, sec.nA * sec.nB
        res = lbfgs_minimize(sec.energy_values, torch.zeros(K, dtype=f64),
                             args=(vals,), maxiter=2000, gtol=1e-8)
        gl = strings.gate_lists(sec._str_tabs._asdict())
        T = gate_scan._threads(nd)
        rows = {}
        for regime, centre, scale in (("near_min", res.x.numpy(), 1e-3),
                                      ("near_0", np.zeros(K), 0.05)):
            rel = {o: [] for o in ("element", "pair")}
            norm = {o: [] for o in rel}
            apart = []
            for seed in range(1, seeds + 1):
                th = centre + scale * np.random.default_rng(seed).normal(
                    size=K)
                theta = torch.tensor(th, requires_grad=True)
                V = sec.state_matrix(theta).detach().reshape(-1)
                Vq = V.clone().requires_grad_()
                E = sec.quadform_values(Vq.reshape(sec.state_shape), vals)
                W, = torch.autograd.grad(E, Vq)
                ref = emulate(V, W, theta.detach(), gl, nA, T,
                              ("pair",))["pair"].numpy()
                # the float64 reference: the exact scan's dtheta (the
                # emulation at float64 agrees with jax.grad to 1e-12)
                got = emulate(V.float(), W.float(), theta.detach().float(),
                              gl, nA, T, ("element", "pair"))
                for o in rel:
                    r, nv = _errors(got[o].double().numpy(), ref)
                    rel[o].extend(r.tolist())
                    norm[o].append(nv)
                apart.append(_errors(got["element"].double().numpy(),
                                     got["pair"].double().numpy())[1])
            rows[regime] = {
                o: dict(median_rel=float(np.median(rel[o])),
                        max_rel=float(np.max(rel[o])),
                        norm_rel_median=float(np.median(norm[o])),
                        norm_rel_max=float(np.max(norm[o])),
                        gates=len(rel[o]))
                for o in rel}
            rows[regime]["orders_apart_norm_rel_max"] = float(max(apart))
        out[name] = dict(gates=K, shape=(sec.nB, nA), threads=T,
                         min_energy_f64=float(res.fun), min_nfev=res.nfev,
                         **rows)
    return out


def counts(starts: dict, which: str) -> dict:
    """Each starting point's first-solve nfev at float32 on the CPU: the
    JAX package's lbfgs_minimize ("jax") or the port's ("port")."""
    out = {}
    for name, (n, parts, maxiter) in PROBLEMS.items():
        if name not in starts:
            continue
        h, g = _integrals(starts[name], n)
        P = starts[name]["parameters"]
        seeds = [r["seed"] for r in starts[name]["runs"]]
        if which == "jax":
            import jax
            jax.config.update("jax_platforms", "cpu")
            import jax.numpy as jnp
            from esoo_tpu.orbital_optimization.kernels import \
                expand_spin_tensors
            from esoo_tpu.sim import HartreeFock, UCCSD
            from esoo_tpu.sim.sector import SectorUCC
            from esoo_tpu.solvers.lbfgs import lbfgs_minimize
            sec = SectorUCC(UCCSD(n, parts,
                                  initial_state=HartreeFock(n, parts)), 2 * n)
            vals = sec.build_values(*expand_spin_tensors(
                jnp.asarray(h, jnp.float32), jnp.asarray(g, jnp.float32)))
            run = jax.jit(lambda x0: lbfgs_minimize(
                sec.energy_values, x0, args=(vals,), maxiter=maxiter,
                gtol=1e-5))
            nfev = [int(run(jnp.asarray(_start(s, P), jnp.float32)).nfev)
                    for s in seeds]
        else:
            import torch
            from esoo_torch.orbital_optimization.kernels import \
                expand_spin_tensors
            from esoo_torch.sim import HartreeFock, UCCSD
            from esoo_torch.sim.sector import SectorUCC
            from esoo_torch.solvers.lbfgs import lbfgs_minimize
            f32 = torch.float32
            sec = SectorUCC(UCCSD(n, parts,
                                  initial_state=HartreeFock(n, parts)), 2 * n)
            vals = sec.build_values(*expand_spin_tensors(
                torch.as_tensor(h, dtype=f32), torch.as_tensor(g, dtype=f32)))
            nfev = [lbfgs_minimize(sec.energy_values,
                                   torch.as_tensor(_start(s, P), dtype=f32),
                                   args=(vals,), maxiter=maxiter,
                                   gtol=1e-5).nfev for s in seeds]
        out[name] = dict(zip(map(str, seeds), nfev))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--starts", required=True)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--jax-counts", action="store_true")
    ap.add_argument("--port-counts", action="store_true")
    ap.add_argument("--skip-errors", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    with open(args.starts) as f:
        starts = json.loads(f.readline())["starts"]
    rec = {}
    if not args.skip_errors:
        rec["dtheta_f32"] = dtheta_errors(starts, args.seeds)
    if args.port_counts:
        rec["port_cpu_first_solve_nfev"] = counts(starts, "port")
    if args.jax_counts:
        rec["jax_cpu_first_solve_nfev"] = counts(starts, "jax")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
