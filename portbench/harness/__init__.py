"""The benchmark's harness: BENCHMARK.json and the files it names
(manifest), the request generator and client, the measured window, the
device trace, the roofline yardstick, and what the metric readers share
(records)."""
