"""The spans of esoo_torch.utils.profiling inside the fused solvers (CPU):
each span's count against the counter it feeds, the timeline that fills
only under a profiler, nests and shares the profiler's clock, and results
bit for bit the same with a profiler running and without one."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esoo_torch import FusedOptOrbCASSCF, FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.orbital_optimization.stiefel import (
    PartialUnitaryProjectionOptimizer)
from esoo_torch.solvers.davidson import davidson_block, davidson_ground
from esoo_torch.utils import profiling

CONSTRUCT_KEYS = ("construct_s", "construct_integrals_s",
                  "construct_sector_s", "construct_ansatz_s")
# the innermost span that may hold each span (None: none)
PARENTS = {"construct": {None}, "construct.integrals": {"construct"},
           "construct.sector": {"construct"},
           "construct.ansatz": {"construct"},
           "outer.rotate": {None, "final_solve"},
           "outer.solve": {None}, "outer.rdms": {None},
           "outer.bb": {None}, "final_solve": {None}, "diagnostics": {None},
           "lbfgs": {"outer.solve", "final_solve"},
           "lbfgs.eval": {"lbfgs"}, "bb.iter": {"outer.bb"},
           "davidson": {"outer.solve", "final_solve"},
           "davidson.build": {"davidson"}, "davidson.sigma": {"davidson"}}


def _vqe(problem, **kw):
    return FusedOptOrbVQE(4, UCCSD(2, (1, 1),
                                   initial_state=HartreeFock(2, (1, 1))),
                          problem=problem, maxiter=20, device="cpu", **kw)


def _casscf(problem, **kw):
    return FusedOptOrbCASSCF(8, problem=problem, maxiter=6, device="cpu",
                             **kw)


def _traced(make):
    """(result, spans, t0, t1): make() built and run under a profiler,
    with the timeline's spans of that run and time_ns stamps taken around
    it."""
    profiling.clear_timeline()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        solver = make()
        result = solver.compute_minimum_energy()
        t1 = time.time_ns()
    return result, profiling.timeline(), t0, t1


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def _parents(spans):
    """The innermost span holding each span (None for a root); asserts the
    spans nest: any two are disjoint or one holds the other."""
    out = []
    for i, (n, s, e) in enumerate(spans):
        holders = []
        for j, (m, s2, e2) in enumerate(spans):
            if i == j:
                continue
            inside = s2 <= s and e <= e2
            outside = s <= s2 and e2 <= e
            assert inside or outside or e <= s2 or e2 <= s, (n, m)
            if inside and not outside:
                holders.append((s2, m))
        out.append(max(holders)[1] if holders else None)
    return out


@pytest.fixture(scope="module")
def vqe_traced(h2_631g):
    return _traced(lambda: _vqe(h2_631g))


@pytest.fixture(scope="module")
def casscf_traced(h4_631g):
    return _traced(lambda: _casscf(h4_631g))


def test_vqe_spans_count_what_stage_stats_counts(vqe_traced):
    r, spans, _, _ = vqe_traced
    st = r.stage_stats
    assert _count(spans, "lbfgs.eval") == st["lbfgs_evaluations"] > 0
    assert _count(spans, "bb.iter") == st["bb_iterations"] > 0
    assert _count(spans, "outer.bb") == len(st["bb_s_per_call"])
    assert _count(spans, "lbfgs") == r.outer_iterations + 1
    assert _count(spans, "outer.rotate") == r.outer_iterations + 1
    assert _count(spans, "construct") == 1
    for k in CONSTRUCT_KEYS + ("rotate_s", "rdms_s", "final_solve_s",
                               "diagnostics_s"):
        assert st[k] > 0.0, k
    assert st["construct_s"] >= (st["construct_integrals_s"]
                                 + st["construct_sector_s"]
                                 + st["construct_ansatz_s"])
    assert st["bb_s"] == pytest.approx(sum(st["bb_s_per_call"]))


def test_casscf_spans_count_what_stage_stats_counts(casscf_traced):
    r, spans, _, _ = casscf_traced
    st = r.stage_stats
    assert _count(spans, "davidson.sigma") == st["davidson_matvecs"] > 0
    assert st["davidson_matvecs"] == sum(st["davidson_matvecs_per_solve"])
    assert _count(spans, "davidson") == st["davidson_solves"] \
        == r.outer_iterations + 1
    assert _count(spans, "davidson.build") == st["davidson_solves"]
    assert _count(spans, "bb.iter") == st["bb_iterations"] > 0
    assert 0.0 < st["sigma_s"] < st["davidson_s"]
    assert st["construct_ansatz_s"] == 0.0      # CASSCF has no ansatz
    for k in ("construct_s", "construct_integrals_s", "construct_sector_s"):
        assert st[k] > 0.0, k


@pytest.mark.parametrize("which", ["vqe", "casscf"])
def test_spans_nest_between_stamps_around_the_solve(which, vqe_traced,
                                                    casscf_traced):
    _, spans, t0, t1 = vqe_traced if which == "vqe" else casscf_traced
    assert spans and all(t0 <= s <= e <= t1 for _, s, e in spans)
    for (name, _, _), parent in zip(spans, _parents(spans)):
        assert parent in PARENTS[name], (name, parent)


def test_bb_iter_counts_passes_of_the_loop_body():
    """One bb.iter a pass of _bb_loop's body: the step before the loop is
    not one (the optimizer reports k, the body ran k - 1 times)."""
    torch.manual_seed(0)
    A = torch.randn(6, 6, dtype=torch.float64)
    A = A + A.T

    def energy(U, A):
        return torch.trace(U.T @ A @ U)

    opt = PartialUnitaryProjectionOptimizer(1e-2, 1e-9, 50, device="cpu")
    stats = {}
    with profiling.collect(stats):
        opt.compute_optimal_rotation(energy, np.eye(6)[:, :2], A)
    assert opt.last_result.iterations > 2
    assert stats["bb_iterations"] == opt.last_result.iterations - 1


@pytest.mark.parametrize("k", [None, 2])
def test_davidson_sigma_spans_count_every_matvec(k):
    torch.manual_seed(1)
    n = 40
    H = torch.randn(n, n, dtype=torch.float64)
    H = H + H.T + torch.diag(torch.arange(n, dtype=torch.float64))
    calls = []

    def mv(x):
        calls.append(1)
        return H @ x

    stats = {}
    with profiling.collect(stats):
        if k is None:
            davidson_ground(mv, torch.diagonal(H).clone(),
                            torch.eye(n, dtype=torch.float64)[0], tol=1e-10)
        else:
            davidson_block(mv, torch.diagonal(H).clone(),
                           torch.eye(n, dtype=torch.float64)[:k], k=k,
                           tol=1e-10)
    assert stats["davidson_matvecs"] == len(calls) > 2
    assert stats["sigma_s"] > 0.0


def test_timeline_fills_only_under_a_profiler_and_is_bounded():
    profiling.clear_timeline()
    stats = {}
    with profiling.collect(stats):
        with profiling.span("untraced", "u_s", "u_n"):
            pass
    assert profiling.timeline() == []
    assert stats["u_n"] == 1 and stats["u_s"] >= 0.0
    cap = profiling.TIMELINE_CAPACITY
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(cap + 5):
            with profiling.span(f"s{i}"):
                pass
    tl = profiling.timeline()
    assert len(tl) == cap
    assert tl[0][0] == "s5" and tl[-1][0] == f"s{cap + 4}"
    profiling.clear_timeline()
    assert profiling.timeline() == []


def test_collect_nests_and_a_span_outside_it_counts_nowhere():
    outer, inner = {}, {}
    with profiling.collect(outer):
        with profiling.collect(inner):
            with profiling.span("a", "a_s", "a_n"):
                pass
        with profiling.collect(None):
            with profiling.span("a", "a_s", "a_n"):
                pass
        with profiling.span("a", "a_s", "a_n") as sp:
            pass
    with profiling.span("a", "a_s", "a_n"):
        pass
    assert inner["a_n"] == 1 and outer["a_n"] == 1
    assert outer["a_s"] == sp.seconds >= 0.0


@pytest.mark.parametrize("which", ["vqe", "casscf"])
def test_results_bit_for_bit_with_and_without_a_profiler(
        which, h2_631g, h4_631g, vqe_traced, casscf_traced):
    if which == "vqe":
        plain = _vqe(h2_631g).compute_minimum_energy()
        traced = vqe_traced[0]
    else:
        plain = _casscf(h4_631g).compute_minimum_energy()
        traced = casscf_traced[0]
    assert plain.eigenvalue == traced.eigenvalue
    assert plain.outer_iterations == traced.outer_iterations
    assert plain.energy_convergence_list == traced.energy_convergence_list
    for k in ("optimal_point", "optimal_partial_unitary",
              "natural_occupations", "one_rdm_spatial"):
        np.testing.assert_array_equal(getattr(plain, k), getattr(traced, k),
                                      err_msg=k)
    for k, v in plain.stage_stats.items():
        if not (k.endswith("_s") or k == "bb_s_per_call"):   # not clocks
            assert traced.stage_stats[k] == v, k


def test_trace_to_carries_the_program_spans(tmp_path):
    """The Chrome trace of trace_to holds the block's spans as host events
    on the trace's time base, around the operators they hold."""
    with profiling.trace_to(str(tmp_path)):
        with profiling.span("esoo.outer"):
            torch.ones(64).sum()
    (path,) = list(tmp_path.iterdir())
    events = json.loads(path.read_text())["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "esoo_span"]
    assert sp["name"] == "esoo.outer" and sp["ph"] == "X"
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert ops
    for op in ops:
        assert sp["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= sp["ts"] + sp["dur"] + 1.0
