"""Linear algebra ops (port of ``paddle_tpu/ops/linalg.py``), also the
``paddle_tpu_torch.linalg`` namespace.

``matmul`` is the white-listed op that ``amp.auto_cast`` runs in low
precision; decompositions are ``torch.linalg``'s.  As in the JAX package:
``lu`` returns 1-based int32 pivots, ``cross`` without an axis takes the
first axis of size 3, ``eig`` / ``eigvals`` run on the host, and
``svd_lowrank`` draws its test matrix from the default generator."""

from __future__ import annotations

import numpy as np
import torch

from ..framework.device import default_device
from ..framework.random import default_generator
from ..framework.tensor import Tensor
from .common import apply, axis_or_none, data_of, np_of, unary_op

__all__ = [
    "matmul", "dot", "bmm", "mv", "t", "norm", "vector_norm", "matrix_norm", "dist",
    "cholesky", "cholesky_solve", "qr", "svd", "svdvals", "pinv", "inv", "det", "slogdet",
    "solve", "triangular_solve", "eig", "eigh", "eigvals", "eigvalsh", "matrix_power",
    "matrix_rank", "einsum", "cross", "multi_dot", "cov", "corrcoef", "lu",
    "householder_product", "tensordot", "cond", "lstsq", "matrix_exp", "cholesky_inverse",
    "lu_unpack", "ormqr", "svd_lowrank", "pca_lowrank",
]


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply("matmul", f, x, y)


def dot(x, y, name=None):
    return apply("dot", lambda a, b: torch.sum(a * b, dim=-1), x, y)


def bmm(x, y, name=None):
    return apply("bmm", torch.matmul, x, y)


def mv(x, vec, name=None):
    return apply("mv", torch.matmul, x, vec)


def t(input, name=None):
    return unary_op("t", lambda a: a.transpose(0, 1) if a.dim() >= 2 else a, input)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    ax = axis_or_none(axis)

    def f(a):
        d = ax if ax is None or isinstance(ax, tuple) else (ax,)
        if p is None or p == "fro":
            if ax is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            if len(d) == 2:
                return torch.linalg.matrix_norm(a, "fro", dim=d, keepdim=keepdim)
            return torch.linalg.vector_norm(a, 2, dim=d, keepdim=keepdim)
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", dim=d or (-2, -1), keepdim=keepdim)
        if p in (float("inf"), "inf"):
            return torch.amax(torch.abs(a), dim=d, keepdim=keepdim) if ax is not None \
                else torch.amax(torch.abs(a))
        if p in (float("-inf"), "-inf"):
            return torch.amin(torch.abs(a), dim=d, keepdim=keepdim) if ax is not None \
                else torch.amin(torch.abs(a))
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), dim=d, keepdim=keepdim)
        dd = d if d is not None else tuple(range(a.dim()))
        return torch.sum(torch.abs(a) ** p, dim=dd, keepdim=keepdim) ** (1.0 / p)

    return unary_op("norm", f, x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p=p, axis=axis, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    ax = tuple(axis)
    return unary_op("matrix_norm",
                    lambda a: torch.linalg.matrix_norm(a, p, dim=ax, keepdim=keepdim), x)


def dist(x, y, p=2, name=None):
    def f(a, b):
        d = a - b
        if p == float("inf"):
            return torch.amax(torch.abs(d))
        if p == float("-inf"):
            return torch.amin(torch.abs(d))
        if p == 0:
            return torch.sum(d != 0).to(a.dtype)
        return torch.sum(torch.abs(d) ** p) ** (1.0 / p)

    return apply("dist", f, x, y)


def cholesky(x, upper=False, name=None):
    return unary_op("cholesky", lambda a: torch.linalg.cholesky(a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    return apply("cholesky_solve", lambda b, chol: torch.cholesky_solve(b, chol, upper=upper),
                 x, y)


def qr(x, mode="reduced", name=None):
    return apply("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), x)


def svd(x, full_matrices=False, name=None):
    return apply("svd", lambda a: tuple(torch.linalg.svd(a, full_matrices=full_matrices)), x)


def svdvals(x, name=None):
    return unary_op("svdvals", torch.linalg.svdvals, x)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return unary_op("pinv", lambda a: torch.linalg.pinv(a, rtol=rcond, hermitian=hermitian), x)


def inv(x, name=None):
    return unary_op("inv", torch.linalg.inv, x)


def det(x, name=None):
    return unary_op("det", torch.linalg.det, x)


def slogdet(x, name=None):
    return apply("slogdet", lambda a: tuple(torch.linalg.slogdet(a)), x)


def solve(x, y, name=None):
    return apply("solve", torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    def f(a, b):
        aa = a.transpose(-1, -2) if transpose else a
        return torch.linalg.solve_triangular(aa, b, upper=upper != transpose,
                                             unitriangular=unitriangular)

    return apply("triangular_solve", f, x, y)


def _host(arr, ref):
    return Tensor._wrap(torch.from_numpy(np.ascontiguousarray(arr)).to(ref.device))


def eig(x, name=None):
    a = data_of(x)
    w, v = np.linalg.eig(np_of(a))
    return _host(w, a), _host(v, a)


def eigvals(x, name=None):
    a = data_of(x)
    return _host(np.linalg.eigvals(np_of(a)), a)


def eigh(x, UPLO="L", name=None):
    return apply("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x)


def eigvalsh(x, UPLO="L", name=None):
    return unary_op("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x)


def matrix_power(x, n, name=None):
    return unary_op("matrix_power", lambda a: torch.linalg.matrix_power(a, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return unary_op("matrix_rank",
                    lambda a: torch.linalg.matrix_rank(a, rtol=tol).to(torch.int32), x)


def einsum(equation, *operands):
    return apply("einsum", lambda *xs: torch.einsum(equation, *xs), *operands)


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = axis
        if ax == 9:  # paddle's default: the first axis of size 3
            ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=ax)

    return apply("cross", f, x, y)


def multi_dot(x, name=None):
    return apply("multi_dot", lambda *xs: torch.linalg.multi_dot(list(xs)), *x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    fw = None if fweights is None else data_of(fweights)
    aw = None if aweights is None else data_of(aweights)

    def f(a):
        m = a if rowvar else a.transpose(0, 1)
        return torch.cov(m, correction=1 if ddof else 0, fweights=fw, aweights=aw)

    return unary_op("cov", f, x)


def corrcoef(x, rowvar=True, name=None):
    return unary_op("corrcoef", lambda a: torch.corrcoef(a if rowvar else a.transpose(0, 1)), x)


def lu(x, pivot=True, get_infos=False, name=None):
    def f(a):
        lu_, piv = torch.linalg.lu_factor(a)
        return lu_, piv.to(torch.int32)

    outs = apply("lu", f, x)
    if get_infos:
        d = data_of(x)
        return outs[0], outs[1], Tensor._wrap(torch.zeros((), dtype=torch.int32,
                                                          device=d.device))
    return outs


def _householder_q(a, tau):
    m = a.shape[-2]
    eye = torch.eye(m, dtype=a.dtype, device=a.device)
    q = torch.broadcast_to(eye, a.shape[:-2] + (m, m))
    ar = torch.arange(m, device=a.device)
    for i in range(tau.shape[-1]):
        v = torch.where(ar < i, torch.zeros((), dtype=a.dtype, device=a.device), a[..., :, i])
        v = torch.where(ar == i, torch.ones((), dtype=a.dtype, device=a.device), v)
        h = eye - tau[..., i][..., None, None] * torch.einsum("...i,...j->...ij", v, v)
        q = q @ h
    return q


def householder_product(x, tau, name=None):
    return apply("householder_product",
                 lambda a, t_: _householder_q(a, t_)[..., :, :a.shape[-1]], x, tau)


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(axes, Tensor):
        ax = axes.tolist()
    if isinstance(ax, (list, tuple)):
        ax = [[int(i) for i in (a.tolist() if isinstance(a, Tensor) else a)]
              if isinstance(a, (list, tuple, Tensor)) else int(a) for a in ax]
    return apply("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax), x, y)


def cond(x, p=None, name=None):
    return unary_op("cond", lambda a: torch.linalg.cond(a, p), x)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """``(solution, residuals, rank, singular_values)``, as ``jnp.linalg
    .lstsq`` (numpy's ``rcond`` rule, ``gelsd``)."""
    def f(a, b):
        res = torch.linalg.lstsq(a.cpu(), b.cpu(), rcond=rcond, driver="gelsd")
        dev = a.device
        return (res.solution.to(dev), res.residuals.to(dev), res.rank.to(dev, torch.int32),
                res.singular_values.to(dev))

    return apply("lstsq", f, x, y)


def matrix_exp(x, name=None):
    return unary_op("matrix_exp", torch.linalg.matrix_exp, x)


def cholesky_inverse(x, upper=False, name=None):
    return unary_op("cholesky_inverse", lambda L: torch.cholesky_inverse(L, upper=upper), x)


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True, name=None):
    return apply("lu_unpack", lambda packed, piv: tuple(torch.lu_unpack(packed, piv)),
                 lu_data, lu_pivots)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    def f(a, t_, other):
        q = _householder_q(a, t_)
        qq = q.transpose(-1, -2) if transpose else q
        return (qq @ other) if left else (other @ qq)

    return apply("ormqr", f, x, tau, y)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomized low-rank SVD (Halko et al. subspace iteration), its test
    matrix drawn from the default generator."""
    d = data_of(x)
    g = default_generator(d.device if isinstance(d, torch.Tensor) else default_device())
    omega = torch.randn(d.shape[:-2] + (d.shape[-1], q), generator=g, device=d.device,
                        dtype=torch.float32)

    def f(a):
        b = a if M is None else a - data_of(M)
        yy = b @ omega.to(a.dtype)
        for _ in range(niter):
            yy = b @ (b.transpose(-1, -2) @ yy)
        Q, _ = torch.linalg.qr(yy)
        B = Q.transpose(-1, -2) @ b
        u_t, s, vh = torch.linalg.svd(B, full_matrices=False)
        return Q @ u_t, s, vh.transpose(-1, -2)

    return apply("svd_lowrank", f, x)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    d = data_of(x)
    k = q if q is not None else min(6, d.shape[-2], d.shape[-1])
    if center:
        from .reduction import mean

        xt = Tensor._wrap(d) if not isinstance(x, Tensor) else x
        x = xt - mean(xt, axis=-2, keepdim=True)
    return svd_lowrank(x, q=k, niter=niter)
