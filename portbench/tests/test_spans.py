"""The program's spans beside the device trace (harness/spans.py): device
events given to the innermost span, on synthetic timelines; the readers of
the six span metrics; the sigma bound's closed count of couplings against
a brute count; and, on the card, the shared clock of the spans and the
profiler's device timeline."""

import itertools
import sys
import types

import numpy as np
import pytest
import torch

from portbench.harness import manifest, roofline, spans, trace
from portbench.reference.sector import Sector

MS = 1_000_000
# two evaluations inside one L-BFGS solve, a BB iteration, and a sigma
SPANS = [("outer.solve", 0, 40 * MS), ("lbfgs", 1 * MS, 39 * MS),
         ("lbfgs.eval", 2 * MS, 10 * MS), ("lbfgs.eval", 20 * MS, 30 * MS),
         ("outer.bb", 50 * MS, 60 * MS), ("bb.iter", 51 * MS, 59 * MS),
         ("davidson.sigma", 70 * MS, 80 * MS),
         ("davidson.sigma", 90 * MS, 100 * MS)]
EVENTS = [("k_eval0_a", 2 * MS, 3 * MS), ("k_eval0_b", 9 * MS, 12 * MS),
          ("k_lbfgs", 15 * MS, 16 * MS), ("k_eval1", 25 * MS, 26 * MS),
          ("k_solve", int(39.5 * MS), 40 * MS),
          ("k_bb_a", 52 * MS, 53 * MS), ("k_bb_b", 53 * MS, 54 * MS),
          ("k_bb_c", 58 * MS, 61 * MS), ("k_outside", 65 * MS, 66 * MS),
          ("k_sigma0", 72 * MS, 76 * MS), ("k_sigma0b", 74 * MS, 78 * MS),
          ("k_sigma1", 85 * MS, 95 * MS)]


def test_each_event_goes_to_the_innermost_span_holding_its_start():
    got = spans.innermost(EVENTS, SPANS)
    names = [None if i is None else SPANS[i][0] for i in got]
    assert names == ["lbfgs.eval", "lbfgs.eval", "lbfgs", "lbfgs.eval",
                     "outer.solve", "bb.iter", "bb.iter", "bb.iter", None,
                     "davidson.sigma", "davidson.sigma", None]
    # the order of either list does not matter
    rev = spans.innermost(EVENTS[::-1], SPANS[::-1])
    assert [None if i is None else SPANS[::-1][i][0] for i in rev] == \
        names[::-1]


def test_events_per_span_and_busy_time_inside_spans():
    assert spans.events_per_span(EVENTS, SPANS, "lbfgs.eval") == 1.5
    assert spans.events_per_span(EVENTS, SPANS, "bb.iter") == 3.0
    assert spans.events_per_span(EVENTS, SPANS, "nothing") is None
    # sigma 0: 72-78 (the union of two events); sigma 1: 90-95 (clipped)
    assert spans.busy_inside(EVENTS, SPANS, "davidson.sigma") == \
        (2, 11 * MS)
    assert spans.busy_inside(EVENTS, SPANS, "nothing") == (0, 0)


def _run(shapes=None, stats=None):
    reqs = [{"failed": False, "traced": False,
             "stage_stats": dict(stats or {})}]
    return {"requests": reqs, "shapes": shapes or {},
            "trace": {"events": EVENTS, "t0_ns": 0, "t1_ns": 200 * MS,
                      "requests": []}}


@pytest.fixture
def timeline(monkeypatch):
    """The program's timeline, replaced by a synthetic one (a stray span
    outside the traced span is left out)."""
    from esoo_torch.utils import profiling
    monkeypatch.setattr(profiling, "timeline",
                        lambda: SPANS + [("lbfgs.eval", 300 * MS,
                                          301 * MS)])


def test_span_metrics_read_the_timeline(timeline):
    shapes = {"m": 8, "n": 4, "nA": 6, "nB": 6, "itemsize": 8}
    run = _run(shapes)
    read = manifest.metric_reader
    assert read("lbfgs_eval_launches")(run) == 1.5
    assert read("bb_iter_launches")(run) == 3.0
    one = spans.sigma_bound_s(4, 6, 6, 8)
    assert read("sigma_roofline")(run) == pytest.approx(
        100 * 2 * one / 11e-3)


def test_stat_metrics_read_the_spans_totals():
    run = _run(stats={"construct_s": 0.05, "sigma_s": 0.3,
                      "davidson_matvecs": 6})
    run["requests"].append({"failed": False, "traced": False,
                            "stage_stats": {"construct_s": 0.15,
                                            "sigma_s": 0.1,
                                            "davidson_matvecs": 2}})
    read = manifest.metric_reader
    assert read("construct_ms")(run) == pytest.approx(100.0)
    assert read("construct_ms.casscf")(run) == pytest.approx(100.0)
    assert read("sigma_ms")(run) == pytest.approx(50.0)


def test_readers_find_nothing_where_there_is_nothing(monkeypatch):
    """Untraced, or a program without spans: every reader returns None."""
    names = ("lbfgs_eval_launches", "bb_iter_launches", "sigma_roofline",
             "construct_ms", "construct_ms.casscf", "sigma_ms")
    untraced = dict(_run(), trace=None)
    for name in names:
        assert manifest.metric_reader(name)(untraced) is None, name
    bare = types.ModuleType("esoo_torch.utils.profiling")
    monkeypatch.setitem(sys.modules, "esoo_torch.utils.profiling", bare)
    run = _run(shapes={"n": 4, "nA": 6, "nB": 6, "itemsize": 8})
    for name in names:
        assert manifest.metric_reader(name)(run) is None, name


def _level(a: int, b: int) -> int:
    return bin(a ^ b).count("1") // 2


def _brute_couplings(n, na, nb) -> int:
    """Pairs of determinants of the sector at most two spin-orbital
    excitations apart, from bitmasks of every determinant."""
    def subsets(k):
        return [sum(1 << i for i in c)
                for c in itertools.combinations(range(n), k)]
    dets = [a | (b << n) for a in subsets(na) for b in subsets(nb)]
    return sum(1 for x in dets for y in dets if _level(x, y) <= 2)


def _dense_nonzeros(n, na, nb) -> int:
    """Nonzero <D|H|D'> of the plain reference's sector Hamiltonian at
    random integrals."""
    rng = np.random.default_rng(11)
    h = rng.normal(size=(n, n))
    h = h + h.T
    a = rng.normal(size=(n,) * 4)
    eri = (a + a.transpose(1, 0, 2, 3) + a.transpose(0, 1, 3, 2)
           + a.transpose(1, 0, 3, 2))
    eri = torch.as_tensor(eri + eri.transpose(2, 3, 0, 1))
    sec = Sector(n, na, nb)
    cols = [sec.sigma(e.reshape(sec.nB, sec.nA), torch.as_tensor(h), eri)
            .reshape(-1) for e in torch.eye(sec.dim, dtype=torch.float64)]
    return int((torch.stack(cols).abs() > 1e-9).sum())


@pytest.mark.parametrize("n,na,nb", [(4, 1, 1), (5, 2, 1), (6, 2, 2)])
def test_sigma_couplings_closed_form_is_the_brute_count(n, na, nb):
    from math import comb
    nd = comb(n, na) * comb(n, nb)
    closed = nd * spans.sigma_couplings(n, na, nb)
    assert closed == _brute_couplings(n, na, nb)
    assert closed == _dense_nonzeros(n, na, nb)


def test_sigma_bound_at_h8():
    """H8 -> 28 (n = 14, (4, 4)) at float64: 2,221 couplings a
    determinant, 4.45 GFLOP, bounded by the float64 rate."""
    assert spans.sigma_couplings(14, 4, 4) == 2221
    nd = 1001 * 1001
    assert spans.sigma_bound_s(14, 1001, 1001, 8) == pytest.approx(
        2 * nd * 2221 / (roofline.PEAK_F32_FLOP_PER_S / 2))
    # the string count fixes the electrons up to k <-> n - k, which the
    # couplings do not tell apart
    assert spans.sigma_couplings(14, 10, 4) == 2221


@pytest.mark.cuda
def test_a_span_holds_its_kernels_on_the_profilers_clock(cuda):
    """Under the harness's CUDA-only profiler a program span around a known
    kernel holds its start (a millisecond of host time on each side of the
    kernel bounds the clocks' disagreement), a span around none holds no
    event, and no device event carries a span's name."""
    import time

    from esoo_torch.utils import profiling
    x = torch.ones(1 << 22, device=cuda)
    x.mul_(1.0)                                 # the kernel loaded
    torch.cuda.synchronize()
    profiling.clear_timeline()
    tracer = trace.Tracer(torch)
    tracer.start()
    for _ in range(3):
        with profiling.span("probe.idle"):
            torch.cuda.synchronize()
        with profiling.span("probe.kernel"):
            time.sleep(1e-3)
            x.mul_(1.0001)
            torch.cuda.synchronize()
            time.sleep(1e-3)
    tr = tracer.stop()
    events = trace.device_events(tr)
    tl = profiling.timeline()
    assert [n for n, _, _ in tl] == ["probe.idle", "probe.kernel"] * 3
    kernels = [e for e in events if "mul" in e[0].lower()]
    owners = [None if i is None else tl[i][0]
              for i in spans.innermost(events, tl)]
    assert kernels and set(owners) == {"probe.kernel"}, (events, tl)
    names = {n for n, _, _ in tl}
    assert not any(e[0] in names for e in events)
