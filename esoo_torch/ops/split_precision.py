"""Exact bf16-split products for sign-structured operands (opt-in).

Port of esoo_tpu/ops/split_precision.py.  The string sector kernels
(sim/strings.py) spend their FLOPs multiplying by the one-body operator
stacks MA/MB, whose entries are JW signs in {0, +-1}: exact in bf16.
Splitting only the *generic* float32 operand into three bf16 terms

    x = hi + mid + lo,   hi = bf16(x), mid = bf16(x - hi), lo = ...

reconstructs every element to ~2^-27 relative, so

    E @ x = E @ hi + E @ mid + E @ lo

is exact at float32 working precision in three bf16 products, issued as
one product of 3x width (the parts stacked along the non-contracted
axis).  On Hopper that moves sigma's sign-operand products from the
float32 CUDA cores (TF32 stays off, the port's precision rule) onto the
bf16 tensor cores.

On a card every product is `torch.mm(..., out_dtype=torch.float32)`:
bf16 operands, float32 accumulation and output, with
`allow_bf16_reduced_precision_reduction` held False for the call.  A
torch without that overload makes the split path raise; it never gives
way to the float32 path.  On the CPU the plain version casts the bf16
parts to float32 before multiplying (sign x bf16 is exact in float32),
so it computes the same function.

Gradients: a plain 3-split routes the whole cotangent through `hi` (the
split is piecewise constant), so `exact_mm`, `exact_mmT` and
`exact_einsum` are autograd Functions whose backward recurses into the
same split product (the adjoint of a sign matrix is its transpose,
again sign-structured).  First order only.

The JAX package also splits its gate scan's one-hot permutation
sandwiches (EB V EA^T).  The port's scan gathers instead
(strings._perm): it has no product to split, and force_split leaves it
bit for bit as it is.

Off by default, and never for float64 (the oracle precision):
`use_split(dtype)`, with `force_split(True)` to opt in.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["split3", "exact_mm", "exact_mmT", "exact_einsum",
           "use_split", "force_split"]

_BF16 = torch.bfloat16


def split3(x: torch.Tensor):
    """float32 -> (hi, mid, lo) bf16 triple with hi + mid + lo == x to
    ~2^-27 relative."""
    hi = x.to(_BF16)
    r1 = x - hi.to(x.dtype)
    mid = r1.to(_BF16)
    lo = (r1 - mid.to(x.dtype)).to(_BF16)
    return hi, mid, lo


@contextlib.contextmanager
def _full_bf16_reduction():
    """Hold cuBLAS to float32 reduction of bf16 products."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 matrices, accumulated and returned in float32."""
    if a.device.type != "cuda":
        return a.float() @ b.float()
    with _full_bf16_reduction():
        try:
            return torch.mm(a, b, out_dtype=torch.float32)
        except TypeError as e:
            raise RuntimeError(
                "the bf16-split path needs torch.mm(..., out_dtype="
                "torch.float32) (bf16 operands, float32 accumulation), "
                f"which this torch {torch.__version__} lacks") from e


def _split_mm(E: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """E @ X, E sign-structured (k, m), X float32 (m, n): one bf16
    product of 3n columns."""
    n = X.shape[1]
    Y3 = _mm_f32(E.to(_BF16), torch.cat(split3(X), dim=1))
    return Y3[:, :n] + Y3[:, n:2 * n] + Y3[:, 2 * n:]


class _ExactMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, E, X):
        ctx.save_for_backward(E)
        return _split_mm(E, X)

    @staticmethod
    def backward(ctx, ct):
        (E,) = ctx.saved_tensors
        return None, exact_mm(E.T, ct)


def exact_mm(E: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``E @ X`` exactly at float32 working precision, E sign-structured
    (entries exact in bf16), X float32.  dX = exact_mm(E.T, ct)."""
    return _ExactMM.apply(E, X)


class _ExactMMT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, E):
        ctx.save_for_backward(E)
        return _split_mm(E, X.T).T

    @staticmethod
    def backward(ctx, ct):
        (E,) = ctx.saved_tensors
        return exact_mmT(ct, E.T), None


def exact_mmT(X: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """``X @ E.T`` exactly at float32 working precision, E sign-structured,
    X float32.  dX = exact_mmT(ct, E.T)."""
    return _ExactMMT.apply(X, E)


def _einsum_parts(spec: str):
    """(E's, X's and the output's index strings) of 'e,x->o'."""
    ins, out = spec.split("->")
    e, x = ins.split(",")
    return e, x, out


def _split_einsum(spec: str, E: torch.Tensor, X: torch.Tensor
                  ) -> torch.Tensor:
    """einsum(spec, E, X) as one split product: E's free indices by the
    contracted ones times the contracted by X's free ones.  Every index
    appears in at most two of the three operands (no batch index)."""
    e, x, out = _einsum_parts(spec)
    con = [c for c in e if c in x]
    fe = [c for c in e if c not in x]
    fx = [c for c in x if c not in e]
    if any(c in out for c in con) or sorted(out) != sorted(fe + fx):
        raise ValueError(f"exact_einsum: {spec!r} is not a plain "
                         "contraction of E's and X's indices")
    size = dict(zip(e, E.shape)) | dict(zip(x, X.shape))
    Em = E.permute([e.index(c) for c in fe + con]).reshape(
        -1, _prod(size[c] for c in con))
    Xm = X.permute([x.index(c) for c in con + fx]).reshape(
        Em.shape[1], -1)
    Y = _split_mm(Em, Xm).reshape([size[c] for c in fe + fx])
    return Y.permute([(fe + fx).index(c) for c in out])


def _prod(it) -> int:
    p = 1
    for v in it:
        p *= int(v)
    return p


class _ExactEinsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, bwd_spec, E, X):
        ctx.specs = (spec, bwd_spec)
        ctx.save_for_backward(E)
        return _split_einsum(spec, E, X)

    @staticmethod
    def backward(ctx, ct):
        (E,) = ctx.saved_tensors
        spec, bwd_spec = ctx.specs
        return None, None, None, exact_einsum(bwd_spec, spec, E, ct)


def exact_einsum(spec: str, bwd_spec: str, E: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, E, X)`` exactly at float32 working precision, with
    the sign-structured operand E first (int8, bf16 or float; cast to
    bf16) and the float32 operand X split.  ``bwd_spec`` contracts E
    with the output's cotangent back to X's indices (spec 'qji,bi->qbj'
    has bwd_spec 'qji,qbj->bi'); the backward recurses into
    exact_einsum."""
    return _ExactEinsum.apply(spec, bwd_spec, E, X)


_FORCE = None          # tests and callers may force True or False


def force_split(flag):
    """Force the split path on (True), off (False), or back to the default
    policy (None).  Returns the previous setting."""
    global _FORCE
    prev = _FORCE
    _FORCE = flag
    return prev


def use_split(dtype) -> bool:
    """Whether the exact bf16-split products run: never for a dtype other
    than float32, and otherwise only under force_split(True) (off by
    default, as in the JAX package, until a measurement on the card says
    it pays; PERF.md)."""
    if dtype != torch.float32:
        return False
    return bool(_FORCE)
