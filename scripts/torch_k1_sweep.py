"""K1 (esoo_torch/csrc/gemm.cu, the narrow trans_x GEMM) on one NVIDIA GPU:
the n-sweep of the transform's stage 1 at m=112, the four chain stages one
by one, the H4 stage 1, and the instruction mix of the compiled kernel.

    python3 scripts/torch_k1_sweep.py [--root CHECKOUT] [--tag NAME]
                                      [--sass-dir DIR]

--root runs the esoo_torch package (and its gemm.cu) of another checkout,
so that two versions are compared in one call on one card; the timing
helpers are this checkout's chip_smoke.py.  Prints one JSON line; writes
the SASS of the narrow kernels to DIR/k1_sass_<tag>.txt (DIR: build/ of
this checkout unless given).

Per shape: the kernel's device time (torch.profiler, mean of 20 calls),
`ms` (CUDA events, median of 50 calls queued behind a device spin), the
library call torch.matmul(x.T, u) timed the same way, and the bound: the
function's bytes (x, u read once, out written once) at the card's memory
rate.  At m=112 the 629 MB x never fits the 50 MB L2.

SASS: `cuobjdump -sass` of the built library; for each narrow kernel, the
opcode counts of its hottest loop (the backward branch whose body holds
the most FMAs) and the count of FMAs per global or shared load there.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return "/usr/local/cuda/bin/cuobjdump"


def _functions(sass: str) -> dict:
    """{function name: [(address, opcode, operands)]} of a SASS dump."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
            continue
        hit = _LINE.search(line)
        if name and hit:
            funcs[name].append((int(hit.group(1), 16), hit.group(3),
                                hit.group(4)))
    return funcs


def _hot_loop(ins: list) -> dict:
    """Opcode counts of the backward branch's body that holds most FMAs."""
    best = None
    for i, (addr, op, rest) in enumerate(ins):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if not m or int(m.group(1), 16) >= addr:
            continue
        lo = int(m.group(1), 16)
        body = [o for a, o, _ in ins if lo <= a <= addr]
        fmas = sum(o.startswith(("FFMA", "DFMA")) for o in body)
        if best is None or fmas > best[0]:
            best = (fmas, body)
    if best is None:
        return {}
    counts = collections.Counter(best[1])
    loads = {k: v for k, v in counts.items() if k.startswith(
        ("LDG", "LDS", "LD.", "LDSM"))}
    fma = sum(v for k, v in counts.items() if k.startswith(("FFMA", "DFMA")))
    ldg = sum(v for k, v in loads.items() if k.startswith(("LDG", "LD.")))
    lds = sum(v for k, v in loads.items() if k.startswith("LDS"))
    return {"instructions": sum(counts.values()), "fma": fma,
            "global_loads": ldg, "shared_loads": lds,
            "async_copies": sum(v for k, v in counts.items()
                                if k.startswith("LDGSTS")),
            "fma_per_global_load": fma / ldg if ldg else None,
            "shared_loads_per_global_load": lds / ldg if ldg else None,
            "opcodes": dict(counts.most_common())}


def sass_report(lib_path: str, out_path: str) -> dict:
    proc = subprocess.run([_cuobjdump(), "-sass", lib_path],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        return {"error": proc.stderr[-2000:]}
    funcs = {k: v for k, v in _functions(proc.stdout).items()
             if "narrow" in k}
    with open(out_path, "w") as f:
        for name, ins in funcs.items():
            f.write(f"Function : {name}\n")
            for addr, op, rest in ins:
                f.write(f"/*{addr:04x}*/ {op}{rest};\n")
    return {name: _hot_loop(ins) for name, ins in funcs.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="this")
    ap.add_argument("--sass-dir", default=os.path.join(HERE, "build"))
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as C                 # timing helpers of this checkout
    sys.path.insert(0, os.path.abspath(args.root))
    for mod in [k for k in sys.modules if k.startswith("esoo_torch")]:
        del sys.modules[mod]
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from esoo_torch.ops import _build, gemm
    if not gemm.__file__.startswith(os.path.abspath(args.root)):
        raise AssertionError(f"imported {gemm.__file__}, not {args.root}")
    card = C.nvidia_smi()
    bw, _ = C.peaks(card)
    dev, f32 = torch.device("cuda"), torch.float32
    gemm._lib()
    os.makedirs(args.sass_dir, exist_ok=True)
    sass = sass_report(_build.library_path("gemm"), os.path.join(
        args.sass_dir, f"k1_sass_{args.tag}.txt"))
    gen = torch.Generator(device=dev).manual_seed(0)

    def shape(K, M, n, flush=None):
        x = torch.randn(K, M, dtype=f32, device=dev, generator=gen)
        u = torch.linalg.qr(torch.randn(K, n, dtype=torch.float64,
                                        device=dev))[0].to(f32).contiguous()
        out = gemm.matmul(x, u, trans_x=True)
        ref = gemm.matmul_plain(x, u, trans_x=True)
        torch.cuda.synchronize()
        err = C.check_close(out, ref, f32, f"K1 K={K} M={M} n={n}")

        def call():
            if flush is not None:
                flush.zero_()
            return gemm.matmul(x, u, trans_x=True)

        nbytes = 4 * (K * M + K * n + M * n)
        kms = C.kernel_ms(call, match="gemm_")
        rec = dict(K=K, M=M, N=n, max_abs_err=err, kernel_ms=kms,
                   ms=C.time_ms(call),
                   library_ms=C.time_ms(lambda: torch.matmul(x.T, u)),
                   library_kernel_ms=C.kernel_ms(lambda: torch.matmul(x.T, u)),
                   bytes=nbytes, bound_ms=nbytes / bw * 1e3)
        rec["pct_of_bound"] = 100 * rec["bound_ms"] / kms
        return rec

    m = 112
    sweep = [shape(m, m ** 3, n) for n in (4, 8, 12, 14, 16)]
    chains = {}
    for n in (14, 16):
        chains[n] = [shape(m, r, n) for r in (m ** 3, m * m * n, m * n * n,
                                              n ** 3)]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    h4 = {"l2_warm": shape(56, 56 ** 3, 4),
          "flushed": shape(56, 56 ** 3, 4, flush=flush)}
    print(json.dumps({"tag": args.tag, "root": args.root, "card": card,
                      "stage1_m112": sweep,
                      "chain_stages_m112": chains, "h4_stage1": h4,
                      "sass_hot_loop": sass}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
