"""The window's arithmetic on synthetic requests: it holds whole requests,
closes at the end of the first that ends past `seconds`, and the metrics
read it as the contract says."""

import statistics
import time

import pytest

from portbench.harness import manifest, window


def _issue(durations):
    it = iter(durations)

    def issue(req, spans):
        d = next(it)
        t0 = time.time_ns()
        time.sleep(d)
        spans.append(("request.solve", t0, time.time_ns()))
        if d < 0:                                   # pragma: no cover
            raise AssertionError
        return {"outputs": {}, "outer_iterations": 3,
                "stage_stats": {"bb_s": d / 2, "bb_iterations": 4}}
    return issue


def _requests():
    i = 0
    while True:
        yield {"index": i}
        i += 1


def test_window_holds_whole_requests_and_overruns_by_less_than_one():
    d = [0.05, 0.02, 0.08, 0.03, 0.06, 0.04, 0.07, 0.05, 0.05, 0.05]
    w = window.run(_issue(d), _requests(), 0.2)
    n = len(w["requests"])
    lat = [r["latency_s"] for r in w["requests"]]
    # closed at the end of the first request that ended past 0.2 s
    assert sum(lat[:-1]) < 0.2 + 0.01 * n
    assert sum(lat) >= 0.2
    assert w["window_s"] >= sum(lat)
    assert [r["index"] for r in w["requests"]] == list(range(n))
    assert len(w["spans"]) == n and w["spans"][0][1] == 0


def test_a_failing_request_is_counted_not_fatal():
    def issue(req, spans):
        if req["index"] == 1:
            raise RuntimeError("planted")
        time.sleep(0.01)
        return {"outputs": {}, "outer_iterations": 1, "stage_stats": {}}
    w = window.run(issue, _requests(), 0.05)
    assert [r["failed"] for r in w["requests"]][:2] == [False, True]


def _run(latencies, window_s):
    return {"window_s": window_s, "setup_s": 1.5, "peak_bytes": 3 * 2 ** 30,
            "requests": [{"latency_s": x, "failed": False, "traced": False,
                          "outer_iterations": 4,
                          "stage_stats": {"bb_s": 0.1, "bb_iterations": 50,
                                          "lbfgs_s": 0.2,
                                          "lbfgs_evaluations": 80}}
                         for x in latencies]}


def test_end_to_end_metrics_on_synthetic_timings():
    lat = [0.5, 0.6, 0.4, 0.9, 1.7, 0.5, 0.55, 0.45, 0.8, 0.65, 0.7]
    run = _run(lat, 7.4)
    read = manifest.metric_reader
    assert read("solve_s")(run) == pytest.approx(7.4 / 11)
    want = statistics.quantiles(lat, n=10, method="inclusive")[8]
    assert read("solve_p90_s")(run) == pytest.approx(want)
    # the p90 of all requests, not a median of chunks
    assert read("solve_p90_s")(run) == pytest.approx(
        window.percentile(lat, 90))
    assert read("peak_device_gib")(run) == pytest.approx(3.0)
    assert read("setup_s")(run) == 1.5


def test_failed_requests_count_for_the_tail_not_the_rate():
    run = _run([0.5, 0.5, 4.0], 5.0)
    run["requests"][2]["failed"] = True
    assert manifest.metric_reader("solve_s")(run) == pytest.approx(2.5)
    assert manifest.metric_reader("solve_p90_s")(run) > 3.0


def test_host_clock_layer_metrics_skip_traced_requests():
    run = _run([0.5] * 4, 2.0)
    run["requests"][0]["traced"] = True
    run["requests"][0]["stage_stats"] = {"bb_s": 9.0, "bb_iterations": 1,
                                         "lbfgs_s": 9.0,
                                         "lbfgs_evaluations": 1}
    read = manifest.metric_reader
    assert read("bb_iter_ms")(run) == pytest.approx(2.0)
    assert read("lbfgs_eval_ms")(run) == pytest.approx(2.5)
    assert read("lbfgs_evals")(run) == pytest.approx(80)
    assert read("outer_iters")(run) == pytest.approx(4)
    assert read("davidson_matvec_ms")(run) is None
