"""The device timeline's reduction on synthetic traces: busy and idle
time, gaps named by the host's spans, kernels found by name, and the
rooflines that read them."""

import pytest

from portbench.harness import manifest, roofline, trace

MS = 1_000_000
EVENTS = [("void gate_scan_fwd<float>(Scan<float>, float const*, float*)",
           10 * MS, 12 * MS),
          ("void gate_scan_bwd<float>(Scan<float>, float const*, float "
           "const*, float*, float*)", 11 * MS, 15 * MS),
          ("Memcpy HtoD (Pageable -> Device)", 30 * MS, 31 * MS),
          ("void transform_slab_pass<float>(float const*, float const*)",
           50 * MS, 51 * MS),
          ("void transform_reduce<float>(float const*, float*, int)",
           51 * MS, 52 * MS),
          ("sm90_xmma_gemm_f32f32", 99 * MS, 130 * MS)]
SPANS = [("request.construct", 0, 0, 20 * MS),
         ("request.solve", 0, 20 * MS, 60 * MS),
         ("request.fetch", 0, 60 * MS, 70 * MS),
         ("request.construct", 1, 70 * MS, 100 * MS)]


def test_busy_and_idle():
    lo, hi = 0, 100 * MS
    assert trace.busy_ns(EVENTS, lo, hi) == (5 + 1 + 2 + 1) * MS
    gaps = trace.gaps(EVENTS, lo, hi)
    assert gaps[0] == (0, 10 * MS)
    assert gaps[-1] == (52 * MS, 99 * MS)
    assert sum(b - a for a, b in gaps) == 91 * MS
    run = {"trace": {"events": EVENTS, "t0_ns": lo, "t1_ns": hi}}
    assert manifest.metric_reader("device_idle_share")(run) == \
        pytest.approx(91.0)


def test_gaps_are_named_by_the_host_span():
    bd = trace.breakdown(EVENTS, SPANS, 0, 100 * MS)
    assert bd["idle_gaps"][0] == ["request.construct r1", pytest.approx(
        0.047)]
    names = [n for n, _ in bd["idle_gaps"]]
    assert "request.construct r0" in names
    assert bd["device_ops"][0] == ["sm90_xmma_gemm_f32f32",
                                   pytest.approx(0.031)]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_kernels_found_by_function_name():
    pat = trace.kernel_re("gate_scan_fwd")
    assert pat.search(EVENTS[0][0])
    assert not pat.search(EVENTS[1][0])
    assert not pat.search("void my_gate_scan_fwd_v2<float>()")


def test_rooflines_from_a_synthetic_trace():
    shapes = {"m": 56, "n": 4, "nA": 6, "nB": 6, "gates": 26, "itemsize": 4}
    reqs = [{"outer_iterations": 4, "failed": False}]
    run = {"shapes": shapes, "trace": {"events": EVENTS, "t0_ns": 0,
                                       "t1_ns": 100 * MS, "requests": reqs}}
    one = roofline.bound_s(roofline.transform_bytes(56, 4),
                           roofline.transform_flops(56, 4))
    got = manifest.metric_reader("transform_roofline")(run)
    assert got == pytest.approx(100 * 5 * one / 2e-3)
    b = roofline.gate_scan_bytes(6, 6, 26)
    f = roofline.gate_scan_flops(6, 6, 26)
    want = (roofline.bound_s(b["fwd"], f["fwd"])
            + roofline.bound_s(b["bwd"], f["bwd"])) / 6e-3
    assert manifest.metric_reader("gate_scan_roofline")(run) == \
        pytest.approx(100 * want)


def test_readers_find_nothing_untraced_and_return_nothing():
    run = {"shapes": {"m": 56, "n": 4, "itemsize": 4}, "trace": None,
           "requests": []}
    for name in ("transform_roofline", "gate_scan_roofline",
                 "device_idle_share"):
        assert manifest.metric_reader(name)(run) is None
