"""The narrow K1 kernel (esoo_torch/csrc/gemm.cu::gemm_narrow_ring) on the
CPU: its decomposition emulated in torch against the JAX package's Pallas
GEMM and the plain product, and its launch plan (ops/gemm.py::_narrow_plan)
held to the card's limits.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
which also holds _narrow_plan equal to the built kernel's own plan).  Here
`_emulate` repeats what the kernel does for out = x^T y, x (K, M), y (K, N):
a persistent grid of B blocks over G groups of R rows, in rounds of tiles
of 256 groups (tile t of block b: groups [(t B + b) 256, +256)), the
groups past the last full round split evenly over the blocks as one
narrower last tile; in each tile the k-rows in ring stages of 16, copies
past M, K or the tile zero-filled; y in chunks of y_rows rows, zero past
K and N; each thread's R x nb accumulators summed in k order; and the
store of each warp's rows in rounds of 8 lanes through the odd-strided
staging buffer, with 16-byte chunks and the ragged last chunk element by
element.  Every output element must be written exactly once.

Tolerances: float32 5e-6 * max(1, max|ref|) (the JAX package's GEMM test);
float64 1e-12 * max(1, max|ref|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.ops.pallas_kernels import matmul_pallas
from esoo_torch.ops import gemm

jax.config.update("jax_enable_x64", True)

H100 = (132, 1)             # SMs and blocks an SM of the kernel on an H100
TWO_BLOCKS = (2, 1)         # full rounds, then a split or an empty last tile
THREADS, OUT_LANES = 256, 8


def _emulate(x: torch.Tensor, y: torch.Tensor, plan: dict) -> torch.Tensor:
    K, M = x.shape
    N = y.shape[1]
    R, nb, ks_rows = plan["rows"], plan["nb"], plan["stage_k"]
    KY, B, G = plan["y_rows"], plan["blocks"], plan["groups"]
    krows = plan["stages"] * ks_rows
    P = nb + 1
    xg = torch.zeros(krows, G * R, dtype=x.dtype)       # zero-filled copies
    xg[:K, :M] = x
    xg = xg.reshape(krows, G, R)
    yp = torch.zeros(-(-krows // KY) * KY, nb, dtype=y.dtype)
    yp[:K, :N] = y
    flat = torch.zeros(M * N, dtype=x.dtype)
    writes = torch.zeros(M * N, dtype=torch.int64)
    full, rest0 = G // (B * THREADS), G // (B * THREADS) * B * THREADS
    for b in range(B):
        last = (rest0 + b * (G - rest0) // B,
                rest0 + (b + 1) * (G - rest0) // B)
        ranges = [((t * B + b) * THREADS, (t * B + b + 1) * THREADS)
                  for t in range(full)] + [last] * (last[1] > last[0])
        for glo, ghi in ranges:
            g = glo + torch.arange(THREADS)
            inside = (g < ghi)[:, None]
            acc = torch.zeros(THREADS, R, nb, dtype=x.dtype)
            for s in range(plan["stages"]):
                ys = yp[s * ks_rows // KY * KY:][:KY]      # the staged chunk
                for kk in range(ks_rows):
                    k = s * ks_rows + kk
                    xr = torch.where(inside, xg[k, g.clamp(max=G - 1)], 0)
                    acc += xr[:, :, None] * ys[k % KY][None, None, :]
            for w in range(THREADS // 32):
                gw = glo + 32 * w
                if gw >= ghi:                              # an idle warp
                    continue
                end = min(ghi * R, M)
                valid = min(32 * R, end - gw * R) * N
                base = gw * R * N
                for rd in range(32 // OUT_LANES):
                    first = rd * OUT_LANES * R * N
                    if first >= valid:
                        break
                    staged = torch.zeros(OUT_LANES * P * R, dtype=x.dtype)
                    for ln in range(OUT_LANES):
                        lane = 32 * w + rd * OUT_LANES + ln
                        staged[ln * P * R:ln * P * R + R * N] = \
                            acc[lane, :, :N].reshape(-1)
                    c = torch.arange(OUT_LANES * N)
                    ln = c // N
                    src = ((ln * P + c - ln * N) * R)[:, None] + \
                        torch.arange(R)
                    e = (first + c * R)[:, None] + torch.arange(R)
                    keep = e < valid
                    flat[base + e[keep]] = staged[src[keep]]
                    writes[base + e[keep]] += 1
    assert bool((writes == 1).all()), "an element written twice or never"
    return flat.reshape(M, N)


def _inputs(M, K, N, dtype, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(K, M))).to(dtype),
            torch.as_tensor(rng.normal(size=(K, N))).to(dtype))


def _close(out, ref):
    ref = torch.as_tensor(np.array(ref))
    tol = (5e-6 if out.dtype == torch.float32 else 1e-12) * max(
        1.0, float(ref.abs().max()))
    assert float((out.double() - ref.double()).abs().max()) <= tol


@pytest.mark.parametrize("card", [H100, TWO_BLOCKS])
@pytest.mark.parametrize("M,K,N", [(729, 112, 16), (729, 3, 14),
                                   (4097, 1, 5), (1030, 300, 12),
                                   (17, 33, 5), (2744, 12, 1),
                                   (1500, 12, 8), (64, 5, 4)])
def test_emulated_kernel_matches_pallas_and_plain(card, M, K, N):
    """Ragged M (729, 17; 4097 one past a tile of float32 groups), M not a
    multiple of 4 (element copies), K of one and several ring stages and
    of several y chunks (300 at float64 and nb 16), N from 1 to 16."""
    for dtype in (torch.float32, torch.float64):
        x, y = _inputs(M, K, N, dtype, seed=M + K + N)
        plan = gemm._narrow_plan(M, K, N, x.element_size(), *card)
        out = _emulate(x, y, plan)
        _close(out, gemm.matmul_plain(x, y, trans_x=True))
        if dtype == torch.float32:
            _close(out, matmul_pallas(jnp.asarray(x.T.numpy()),
                                      jnp.asarray(y.numpy()),
                                      interpret=True))


@pytest.mark.parametrize("n", [14, 16])
def test_emulated_kernel_runs_the_chain_stages(n):
    """The transform's four stages at a small m (the K1 chain's shapes at
    m = 8): (m, m^3), (m, m^2 n), (m, m n^2), (m, n^3), each (rest, n)
    output the next stage's (m, rest') input, against the JAX package."""
    from esoo_tpu.orbital_optimization import kernels as JK
    m = 8
    rng = np.random.default_rng(n)
    g = rng.normal(size=(m,) * 4)
    u = np.linalg.qr(rng.normal(size=(m, n)))[0] if n <= m else \
        rng.normal(size=(m, n))
    t, ut, rest = torch.as_tensor(g), torch.as_tensor(u), m ** 3
    for _ in range(4):
        x = t.reshape(m, rest)
        t = _emulate(x, ut, gemm._narrow_plan(rest, m, n, 8, *H100))
        rest = rest // m * n
    _close(t.reshape((n,) * 4), JK.rotate_two_body(jnp.asarray(g),
                                                   jnp.asarray(u)))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("N", [1, 4, 5, 8, 9, 16])
def test_plan_fits_a_block_in_shared_memory(itemsize, N):
    """Dynamic shared memory under the 227 KB a block may use, the ring's
    64 KB of copies in flight a block; a y chunk holds whole ring stages
    and all of y at m = 112."""
    plan = gemm._narrow_plan(1000, 112, N, itemsize, *H100)
    assert plan["nb"] >= N and plan["nb"] in (4, 8, 16)
    assert plan["rows"] * itemsize == 16
    assert plan["smem"] <= gemm._SMEM_LIMIT
    assert (plan["ring"] - 1) * plan["stage_k"] * 256 * 16 == 64 * 1024
    assert plan["y_rows"] % plan["stage_k"] == 0
    assert plan["y_rows"] >= 112
    assert plan["stages"] == 7


def test_plan_takes_rows_beyond_the_tile_grid():
    """M above 65535 * 64 (stage 1 at m >= 162): a 1-D grid of SMs x
    blocks an SM; the blocks' ranges cover every group once."""
    M = 65535 * 64 + 1000
    plan = gemm._narrow_plan(M, 3, 4, 4, *H100)
    assert plan["blocks"] == 132
    G, B = plan["groups"], plan["blocks"]
    assert G == -(-M // 4)
    full = G // (B * 256)
    rest0 = full * B * 256
    tiles = sorted((t * B + b) * 256 for t in range(full) for b in range(B))
    assert tiles == list(range(0, rest0, 256))
    bounds = [rest0 + b * (G - rest0) // B for b in range(B + 1)]
    assert bounds[-1] == G
    sizes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) <= 256


@pytest.mark.parametrize("M,blocks", [(112 ** 3, 132), (112 * 112 * 16, 132),
                                      (112 * 16 * 16, 132), (16 ** 3, 32),
                                      (17, 1)])
def test_plan_spreads_the_chain_stages(M, blocks):
    """At (m, n) = (112, 16), float32: stages 1 to 3 fill the persistent
    grid (stage 3, M = 28,672, with 54 groups a block), stage 4 (M =
    4,096) takes a block for each warp's worth of rows, not four tiles of
    1024."""
    plan = gemm._narrow_plan(M, 112, 16, 4, *H100)
    assert plan["blocks"] == blocks
    assert plan["vec"] == int(M % 4 == 0)
