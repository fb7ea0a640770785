"""The one-pass 4-index transform (esoo_torch/csrc/transform.cu) on the CPU:
its block decomposition emulated in torch against the JAX package, and the
route choice of ops/gemm.py::_transform_plan.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
Here `_emulate` repeats its arithmetic in its order: B blocks over
contiguous ranges of the m^2 slabs S_pq = g[p,q,:,:]; per slab
T'[k,s] = sum_r u[r,k] S_pq[r,s] and Y[j,k,s] += u[q,j] T'[k,s]; when p
changes or the range ends, V[j,k,l] = sum_s Y[j,k,s] u[s,l] and the
block's partial gains u[p,i] V[j,k,l]; then the B partials summed in index
order.  (That is the per-slab T = S u, A = u^T T, acc += u[p] (x) u[q] (x)
A, with the sums over q and s taken later.)  Tolerance 1e-12 *
max(1, max|ref|) at float64: the two packages sum in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.ops.pallas_kernels import rotate_two_body_pallas
from esoo_tpu.orbital_optimization import kernels as JK
from esoo_torch.ops import gemm

jax.config.update("jax_enable_x64", True)

H100_BLOCKS = 2 * 132          # the kernel's grid on an H100 SXM


def _emulate(g: torch.Tensor, u: torch.Tensor, blocks: int) -> torch.Tensor:
    m, n = u.shape
    pairs = m * m
    slabs = g.reshape(pairs, m, m)
    partials = torch.zeros(blocks, n, n, n, n, dtype=g.dtype)
    for b in range(blocks):
        lo, hi = b * pairs // blocks, (b + 1) * pairs // blocks
        Y = torch.zeros(n, n, m, dtype=g.dtype)             # Y[j, k, s]
        for pair in range(lo, hi):
            p, q = divmod(pair, m)
            Tp = u.T @ slabs[pair]                           # T'[k, s]
            Y += u[q][:, None, None] * Tp[None]
            if q == m - 1 or pair == hi - 1:                 # p ends here
                V = Y @ u                                    # V[j, k, l]
                partials[b] += u[p][:, None, None, None] * V[None]
                Y.zero_()
    out = torch.zeros(n, n, n, n, dtype=g.dtype)
    for b in range(blocks):
        out += partials[b]
    return out


def _inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m,) * 4)
    u = np.linalg.qr(rng.normal(size=(m, n)))[0]
    return g, u


def _assert_close(out, ref):
    ref = np.asarray(ref)
    tol = 1e-12 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("blocks", [1, 5, H100_BLOCKS])
@pytest.mark.parametrize("m,n", [(9, 3), (8, 4), (4, 2), (12, 8), (7, 1),
                                 (14, 6)])
def test_block_decomposition_matches_jax(m, n, blocks):
    g, u = _inputs(m, n, seed=10 * m + n)
    out = _emulate(torch.as_tensor(g), torch.as_tensor(u), blocks)
    _assert_close(out, JK.rotate_two_body(jnp.asarray(g), jnp.asarray(u)))
    _assert_close(out, rotate_two_body_pallas(jnp.asarray(g),
                                              jnp.asarray(u)))


@pytest.mark.parametrize("m,blocks", [(4, H100_BLOCKS), (9, 5), (12, 7)])
def test_block_ranges_cover_each_slab_once(m, blocks):
    """Contiguous ranges in block order: every slab once, in g's order,
    with empty ranges when blocks outnumber slabs."""
    pairs = m * m
    ranges = [(b * pairs // blocks, (b + 1) * pairs // blocks)
              for b in range(blocks)]
    covered = [pair for lo, hi in ranges for pair in range(lo, hi)]
    assert covered == list(range(pairs))
    assert (sum(lo == hi for lo, hi in ranges) > 0) == (blocks > pairs)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_takes_the_fused_kernel_up_to_n_8(itemsize):
    for m, n in ((56, 8), (24, 8), (4, 1), (4, 2)):
        route, stages = gemm._transform_plan(m, n, itemsize)
        assert route == "fused" and 2 <= stages <= gemm._MAX_STAGES
    assert gemm._transform_plan(56, 9, itemsize) == ("chain", 0)
    assert gemm._transform_plan(24, 12, itemsize) == ("chain", 0)
    assert gemm._transform_plan(300, 4, itemsize) == ("chain", 0)


@pytest.mark.parametrize("itemsize,m_two,m_chain", [(4, 163, 164),
                                                    (8, 110, 111)])
def test_plan_at_the_shared_memory_limit(itemsize, m_two, m_chain):
    """The deepest ring that fits; past two slabs in 227 KB, the chain."""
    n = 4
    assert gemm._transform_plan(m_two, n, itemsize) == ("fused", 2)
    assert gemm._transform_smem(m_two, n, itemsize, 3) > gemm._SMEM_LIMIT
    assert gemm._transform_smem(m_two, n, itemsize, 2) <= gemm._SMEM_LIMIT
    assert gemm._transform_plan(m_chain, n, itemsize) == ("chain", 0)
    assert gemm._transform_smem(m_chain, n, itemsize, 2) > gemm._SMEM_LIMIT


@pytest.mark.parametrize("itemsize,stages,slab", [(4, 5, 64 * 64),
                                                  (8, 3, 56 * 56)])
def test_plan_at_the_headline_shape(itemsize, stages, slab):
    """m = 56, n = 4: float32 takes the fast path's 64 x 64 slabs, and the
    ring is as deep as lets two blocks share an SM."""
    m, n = 56, 4
    assert gemm._transform_plan(m, n, itemsize) == ("fused", stages)
    smem = gemm._transform_smem(m, n, itemsize, stages)
    assert smem == itemsize * (stages * slab + m * n + 256 * 16 + 4 ** 3)
    assert smem <= gemm._SMEM_TWO_BLOCKS
    assert gemm._transform_smem(m, n, itemsize, stages + 1) > \
        gemm._SMEM_TWO_BLOCKS


@pytest.mark.parametrize("itemsize,plan", [(4, ("fused", 4)),
                                           (8, ("chain", 0))])
def test_plan_at_the_full_space_shape(itemsize, plan):
    """m = 112, n = 6 (the H8 -> 12 full-space path): float32 takes the
    one-pass kernel with a 4-slab ring of 112 x 112 slabs, one block an
    SM (222,720 bytes of the 227 KB); float64 fits no 2-slab ring and
    takes the chain."""
    m, n = 112, 6
    assert gemm._transform_plan(m, n, itemsize) == plan
    smem = gemm._transform_smem(m, n, itemsize, 4)
    assert smem == itemsize * (4 * m * m + m * 8 + 256 * 16 + 8 ** 3)
    if itemsize == 4:
        assert gemm._SMEM_TWO_BLOCKS < smem <= gemm._SMEM_LIMIT
        assert gemm._transform_smem(m, n, 4, 5) > gemm._SMEM_LIMIT
    else:
        assert gemm._transform_smem(m, n, 8, 2) > gemm._SMEM_LIMIT


@pytest.mark.parametrize("itemsize,stride", [(4, 84), (8, 82)])
def test_plan_pads_odd_slabs_to_16_bytes(itemsize, stride):
    """m = 9: 81-element slabs sit in the ring at a 16-byte stride; u takes
    4 columns for n = 3."""
    m, n = 9, 3
    assert gemm._transform_plan(m, n, itemsize) == ("fused", 8)
    assert gemm._transform_smem(m, n, itemsize, 2) == itemsize * (
        2 * stride + m * 4 + 256 * 16 + 4 ** 3)
