"""One cell in one process: its inputs, the port's problem and client, the
warm-up, the measured window, the traced requests after it, and the check
of every request served.
"""

from __future__ import annotations

import gc
import sys

from . import client as _client
from . import generator, trace as _trace, window as _window

# top-level module names no process of the benchmark may hold: JAX, its
# libraries and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "esoo_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in sys.modules (each name compared
    whole: the part before the first dot)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Session:
    def __init__(self, config: dict, traffic: dict, device: str = "cuda",
                 cache_root: str = None):
        import torch

        import esoo_torch as T
        from portbench import inputs as _inputs
        from portbench.reference import ucc

        cap = config.get("outer_maxiter")
        if cap is not None and traffic["options"].get("maxiter") != cap:
            raise ValueError(f"the configuration caps the outer loop at "
                             f"{cap}, the traffic at "
                             f"{traffic['options'].get('maxiter')}")
        self.torch = torch
        self.config, self.traffic = config, traffic
        self.device = device
        self.inputs = _inputs.load(config, cache_root)
        self.dtype = getattr(torch, config["precision"]["dtype"])
        want_tf32 = bool(config["precision"].get("tf32", False))
        if torch.backends.cuda.matmul.allow_tf32 != want_tf32:
            raise RuntimeError("the port's TF32 setting differs from the "
                               "configuration's precision")
        self.problem = _client.problem(self.inputs)
        self.client = _client.Client(T, torch, self.problem, traffic,
                                     self.dtype, device)
        n = traffic["active_spin_orbitals"] // 2
        na, nb = self.inputs["num_particles"]
        from math import comb
        self.shapes = {"m": config["num_spatial_orbitals"], "n": n,
                       "nA": comb(n, na), "nB": comb(n, nb),
                       "itemsize": torch.empty((), dtype=self.dtype)
                       .element_size()}
        if self.client.ansatz is not None:
            gates = len(ucc.excitations(n, na, nb))
            if gates != self.client.ansatz.num_parameters:
                raise RuntimeError(f"the ansatz has "
                                   f"{self.client.ansatz.num_parameters} "
                                   f"parameters, the reference {gates}")
            self.shapes["gates"] = gates

    def sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize()

    def warmup(self, seed: int) -> None:
        """One request from the warm-up stream: every shape the timed
        requests use is built and loaded before the window."""
        self.client.issue(generator.request(self.traffic, self.config, seed,
                                            0, warmup=True), [])
        self.sync()

    def measure(self, seed: int, seconds: float, traced: bool) -> dict:
        """One window from `seed` (no profiler in the process), then, with
        `traced`, the traffic's `trace_requests` next requests under the
        profiler: the run record (harness/records.py)."""
        torch = self.torch
        cuda = torch.device(self.device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        self.sync()
        reqs = generator.requests(self.traffic, self.config, seed)
        w = _window.run(self.client.issue, reqs, seconds)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        run = {"window_s": w["window_s"], "requests": w["requests"],
               "spans": w["spans"], "peak_bytes": peak,
               "shapes": dict(self.shapes), "trace": None}
        if traced:
            run["trace"] = self._trace(reqs, run)
        return run

    def _trace(self, reqs, run: dict) -> dict:
        """Serve the next requests under the profiler; they join the run's
        requests (checked like the others, read by no host clock)."""
        tracer = _trace.Tracer(self.torch)
        tracer.start()
        done = [_window.serve(self.client.issue, next(reqs), run["spans"],
                              traced=True)
                for _ in range(int(self.traffic["trace_requests"]))]
        tr = tracer.stop()
        run["requests"] += done
        return {"events": _trace.device_events(tr), "t0_ns": tr["t0_ns"],
                "t1_ns": tr["t1_ns"], "requests": done}

    def free(self) -> None:
        """Release what the program left on the card before the check."""
        gc.collect()
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, run: dict) -> dict:
        """The reference's readings of every completed request: {name:
        worst reading}, and under "requests" each one's readings, latency
        and outer iterations."""
        from portbench.reference import checker
        check = checker(self.traffic["reference"])(
            self.inputs, self.traffic["active_spin_orbitals"] // 2,
            self.traffic.get("reference_device", self.device))
        worst, per = {}, []
        for r in run["requests"]:
            if r["failed"]:
                continue
            got = check.readings(r["outputs"], r["start"])
            per.append({"readings": got, "latency_s": r["latency_s"],
                        "outer_iterations": r["outer_iterations"],
                        "traced": r["traced"]})
            for k, v in got.items():
                worst[k] = max(worst.get(k, 0.0), v)
        del check
        self.free()
        return {"worst": worst, "requests": per}


def judge(worst: dict, limits: dict, attempted: int, failed: int):
    """(correct, {name: {"value", "limit"}}) of the compared numbers."""
    rows = {name: {"value": worst.get(name), "limit": lim}
            for name, lim in limits.items()}
    ok = (attempted > 0 and failed == 0
          and all(r["value"] is not None and r["value"] <= r["limit"]
                  for r in rows.values()))
    return ok, rows
