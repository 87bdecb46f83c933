"""Linear algebra (counterpart of ``paddle_tpu/tensor/linalg.py`` and the
``paddle.linalg`` namespace), through ``torch.linalg``.

On the card ``torch.linalg`` calls cuSOLVER, whose signs and orders of
the factors of ``eig``, ``eigh``, ``svd``, ``qr`` and ``lu`` may differ
from LAPACK's where they are not unique; the products they reconstruct,
the singular values and the sorted eigenvalues agree. ``eig`` and
``eigvals`` return real dtypes when every eigenvalue is real, as
numpy (and so the reference) does: that reads the result on the host.
"""
from __future__ import annotations

import builtins
import math as _math

import torch

from ..amp.auto_cast import cast_inputs
from ..framework import random as _random
from ._common import canon, tensors
from .manipulation import t  # noqa: F401
from .math import bmm, cross, dot, inner, matmul, mv, outer  # noqa: F401


def _op(name, *xs):
    return cast_inputs(name, *tensors(*xs))


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The vector norm of the flattened ``x`` (``axis`` None; 2 for
    ``p`` None or 'fro'), the vector norm along an int ``axis``, or the
    matrix norm over a pair of axes ('fro' for ``p`` None)."""
    (a,) = _op("norm", x)
    if axis is None:
        ordv = 2 if p in (None, "fro") else p
        return canon(torch.linalg.vector_norm(a.reshape(-1), ordv))
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return canon(torch.linalg.matrix_norm(
            a, "fro" if p is None else p, tuple(axis), keepdim=keepdim))
    ax = axis[0] if isinstance(axis, (list, tuple)) else axis
    ordv = 2 if p in (None, "fro") else p
    return canon(torch.linalg.vector_norm(a, ordv, ax, keepdim=keepdim))


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    (a,) = _op("vector_norm", x)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return canon(torch.linalg.vector_norm(a, p, ax, keepdim=keepdim))


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    """The matrix norm over the last two dims (``axis`` is taken as the
    reference takes it: not read)."""
    (a,) = _op("matrix_norm", x)
    return canon(torch.linalg.matrix_norm(a, p, keepdim=keepdim))


def dist(x, y, p=2, name=None):
    a, b = _op("dist", x, y)
    return canon(torch.linalg.vector_norm((a - b).reshape(-1), p))


def cond(x, p=None, name=None):
    (a,) = _op("cond", x)
    return canon(torch.linalg.cond(a, p))


def cholesky(x, upper=False, name=None):
    (a,) = _op("cholesky", x)
    return canon(torch.linalg.cholesky(a, upper=upper))


def cholesky_solve(x, y, upper=False, name=None):
    """``A^-1 x`` for ``A`` given by its Cholesky factor ``y``."""
    b, f = _op("cholesky_solve", x, y)
    return canon(torch.cholesky_solve(b, f, upper=upper))


def qr(x, mode="reduced", name=None):
    """``(Q, R)``; only ``R`` for ``mode="r"``."""
    (a,) = _op("qr", x)
    q, r = torch.linalg.qr(a, mode)
    return canon(r) if mode == "r" else canon((q, r))


def svd(x, full_matrices=False, name=None):
    (a,) = _op("svd", x)
    return canon(tuple(torch.linalg.svd(a, full_matrices=full_matrices)))


def svdvals(x, name=None):
    (a,) = _op("svdvals", x)
    return canon(torch.linalg.svdvals(a))


def eigh(x, UPLO="L", name=None):
    (a,) = _op("eigh", x)
    return canon(tuple(torch.linalg.eigh(a, UPLO)))


def eigvalsh(x, UPLO="L", name=None):
    (a,) = _op("eigvalsh", x)
    return canon(torch.linalg.eigvalsh(a, UPLO))


def _real_if_real(w, *rest):
    """The eigenvalues ``w`` (and ``rest``) as real tensors when every
    eigenvalue is real."""
    if bool((w.imag == 0).all()):
        return (w.real,) + tuple(t.real for t in rest)
    return (w,) + rest


def eig(x, name=None):
    """Eigenvalues and eigenvectors of a general matrix, complex unless
    every eigenvalue is real (numpy's rule, which the reference
    follows): that is decided on the host."""
    (a,) = tensors(x)
    w, v = torch.linalg.eig(a)
    return canon(_real_if_real(w, v))


def eigvals(x, name=None):
    (a,) = tensors(x)
    return canon(_real_if_real(torch.linalg.eigvals(a))[0])


def inv(x, name=None):
    (a,) = _op("inv", x)
    return canon(torch.linalg.inv(a))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    (a,) = _op("pinv", x)
    return canon(torch.linalg.pinv(a, rtol=rcond, hermitian=hermitian))


def solve(x, y, name=None):
    a, b = _op("solve", x, y)
    return canon(torch.linalg.solve(a, b))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    """``x^-1 y`` (``x^-T y`` with ``transpose``) for a triangular
    ``x``."""
    a, b = _op("triangular_solve", x, y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return canon(torch.linalg.solve_triangular(
        a, b, upper=upper, unitriangular=unitriangular))


def lstsq(x, y, rcond=None, driver=None, name=None):
    """The least-squares solution, the residual sums of squares (empty
    unless ``x`` is tall and of full rank), the rank (int32) and the
    singular values of ``x``: numpy's four results, as the reference
    gives them. As numpy's, the singular values at or below ``rcond``
    times the largest (``eps * max(m, n)`` when it is None) count as
    zero, in the solution and in the rank alike; the solution is the
    pseudo-inverse's on every device. The rank is read on the host."""
    a, b = tensors(x, y)
    m, n = a.shape[-2], a.shape[-1]
    tol = (rcond if rcond is not None
           else torch.finfo(a.dtype).eps * builtins.max(m, n))
    sol = torch.linalg.pinv(a, rtol=tol) @ b
    sv = torch.linalg.svdvals(a)
    rank = (sv > tol * sv.max()).sum()
    if m > n and int(rank) == n:
        res = ((a @ sol - b) ** 2).sum(-2)
    else:
        res = torch.zeros(0, dtype=a.dtype, device=a.device)
    return canon((sol, res, rank, sv))


def lu(x, pivot=True, get_infos=False, name=None):
    """The packed LU factor and LAPACK's 1-based int32 pivots (and a 0
    info with ``get_infos``)."""
    (a,) = _op("lu", x)
    lu_mat, piv = torch.linalg.lu_factor(a)
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_mat, piv, torch.zeros((), dtype=torch.int32,
                                        device=a.device)
    return lu_mat, piv


def matrix_power(x, n, name=None):
    (a,) = _op("matrix_power", x)
    return canon(torch.linalg.matrix_power(a, n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    (a,) = tensors(x)
    return torch.linalg.matrix_rank(a, rtol=tol).to(torch.int32)


def det(x, name=None):
    (a,) = _op("det", x)
    return canon(torch.linalg.det(a))


def slogdet(x, name=None):
    """``[sign, log|det|]`` stacked on a new first dim."""
    (a,) = _op("slogdet", x)
    sign, logabs = torch.linalg.slogdet(a)
    return canon(torch.stack([sign, logabs]))


def multi_dot(x, name=None):
    return canon(torch.linalg.multi_dot(list(_op("multi_dot", *x))))


def matmul_transpose(x, y, name=None):
    a, b = _op("matmul_transpose", x, y)
    return canon(a @ b.transpose(-1, -2))


def tensordot(x, y, axes=2, name=None):
    a, b = _op("tensordot", x, y)
    if isinstance(axes, torch.Tensor):
        axes = axes.tolist()
    if isinstance(axes, (list, tuple)):
        axes = [list(v) if isinstance(v, (list, tuple)) else [v]
                for v in axes]
    return canon(torch.tensordot(a, b, axes))


def householder_product(x, tau, name=None):
    a, t_ = _op("householder_product", x, tau)
    return canon(torch.linalg.householder_product(a, t_))


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """``(P, L, U)`` with ``P @ L @ U`` the factored matrix, from
    :func:`lu`'s packed factor ``x`` and 1-based pivots ``y``."""
    a, piv = _op("lu_unpack", x, y)
    p, lo, up = torch.lu_unpack(a, piv.to(torch.int32))
    return canon((p, lo, up))


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distances ``[*, P, R]`` of the rows of ``x``
    ``[*, P, M]`` and ``y`` ``[*, R, M]``; for p = 2 through one matmul
    (``|a|^2 + |b|^2 - 2 a.b``, clamped at 0), as the reference."""
    a, b = _op("cdist", x, y)
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        a2 = torch.sum(a * a, -1)[..., :, None]
        b2 = torch.sum(b * b, -1)[..., None, :]
        ab = torch.einsum("...pm,...rm->...pr", a, b)
        return canon(torch.sqrt(torch.clamp_min(a2 + b2 - 2.0 * ab, 0.0)))
    diff = torch.abs(a[..., :, None, :] - b[..., None, :, :])
    if p == 0.0:
        return canon(torch.sum((diff != 0).to(a.dtype), -1))
    if _math.isinf(p):
        return canon(torch.amax(diff, -1))
    return canon(torch.sum(diff ** p, -1) ** (1.0 / p))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    """The covariance of the rows (``rowvar``) or columns of ``x``,
    computed in fp32 with the frequency and analytic weights."""
    a, fw, aw = _op("cov", x, fweights, aweights)
    obs = a if rowvar else a.t()
    if obs.dim() == 1:
        obs = obs[None]
    x32 = obs.to(torch.float32)
    w = None
    if fw is not None:
        w = fw.to(torch.float32)
    if aw is not None:
        aw = aw.to(torch.float32)
        w = aw if w is None else w * aw
    if w is None:
        n = x32.shape[1]
        xc = x32 - x32.mean(1, keepdim=True)
        out = xc @ xc.t() / builtins.max(n - (1 if ddof else 0), 1)
    else:
        wsum = w.sum()
        xc = x32 - (x32 * w).sum(1, keepdim=True) / wsum
        if ddof and aw is not None:
            denom = wsum - (w * aw).sum() / wsum
        elif ddof:
            denom = wsum - 1
        else:
            denom = wsum
        out = (xc * w) @ xc.t() / torch.clamp_min(denom, 1e-12)
    return canon(out.to(a.dtype))


def corrcoef(x, rowvar=True, name=None):
    """Pearson correlation of the rows (``rowvar``) or columns, in fp32,
    clamped to [-1, 1]."""
    (a,) = _op("corrcoef", x)
    obs = a if rowvar else a.t()
    if obs.dim() == 1:
        obs = obs[None]
    x32 = obs.to(torch.float32)
    xc = x32 - x32.mean(1, keepdim=True)
    c = xc @ xc.t() / builtins.max(x32.shape[1] - 1, 1)
    d = torch.sqrt(torch.clamp(torch.diag(c), 1e-30, None))
    return canon(torch.clamp(c / d[:, None] / d[None, :], -1.0, 1.0)
                 .to(a.dtype))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized low-rank PCA ``(U, S, V)`` of rank ``q`` (default
    ``min(6, m, n)``): a Gaussian range finder with ``niter`` power
    iterations, its draw from the device's generator
    (``framework.random``)."""
    (a,) = _op("pca_lowrank", x)
    m, n = a.shape[-2], a.shape[-1]
    rank = q if q is not None else builtins.min(6, m, n)
    xf = a.to(torch.float32)
    xc = xf - xf.mean(-2, keepdim=True) if center else xf
    xt = xc.transpose(-1, -2)
    _random.note_draw()
    g = torch.randn(n, rank, generator=_random.generator(a.device),
                    device=a.device)
    y = xc @ g
    for _ in range(builtins.max(int(niter), 0)):
        y = torch.linalg.qr(xc @ (xt @ y))[0]
    qmat = torch.linalg.qr(y)[0]
    b = qmat.transpose(-1, -2) @ xc
    u_small, s, vt = torch.linalg.svd(b, full_matrices=False)
    return canon(((qmat @ u_small).to(a.dtype), s.to(a.dtype),
                  vt.transpose(-1, -2).to(a.dtype)))

