"""The tables of the port's tensor-op tests, free of JAX.

``tests/test_torch_tensor_ops.py`` runs them against the reference on
the CPU; ``chip_smoke.py`` phase 23 runs them on the card against the
port's own CPU results. ``call(m, *xs)`` in a ``CASES`` row drives
either package (``m`` is ``paddle_tpu`` or ``paddle_tpu_torch``).
:func:`covered` names every tensor function these tables call, as a
:class:`Recorder` of the port sees them resolved while the rows run.
"""
from __future__ import annotations

import functools
import types

import numpy as np
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework.device import using_device

_R = np.random.RandomState(23)
X = _R.uniform(-1, 1, (3, 4)).astype(np.float32)
Y = _R.uniform(-1, 1, (3, 4)).astype(np.float32)
P = _R.uniform(0.2, 0.8, (3, 4)).astype(np.float32)   # in (0, 1)
V = _R.uniform(-1, 1, (4,)).astype(np.float32)
A = _R.uniform(-1, 1, (4, 3)).astype(np.float32)
B = _R.uniform(-1, 1, (5, 3)).astype(np.float32)
SQ = _R.uniform(-1, 1, (4, 4)).astype(np.float32)
SPD = (SQ @ SQ.T + 4 * np.eye(4)).astype(np.float32)
X3 = _R.uniform(-1, 1, (2, 3, 4)).astype(np.float32)
I = _R.randint(1, 12, (3, 4)).astype(np.int64)
J = _R.randint(1, 12, (3, 4)).astype(np.int64)
SH = _R.randint(0, 4, (3, 4)).astype(np.int64)
Z = np.array([[0, 1, 0, 3], [2, 0, 0, 1], [0, 0, 0, 0]], np.int64)
NAN = np.array([[1.0, np.nan, 3.0, np.inf], [-np.inf, 2.0, np.nan, 0.5]],
               np.float32)
TIES = np.array([[1, 3, 3, 2, 3], [2, 1, 1, 0, 0]], np.float32)
MASK = X > 0
PTS = _R.uniform(0, 1, (40, 2)).astype(np.float32)
SEQ = np.sort(_R.uniform(-1, 1, (6,)).astype(np.float32))
W = _R.randint(1, 4, (4,)).astype(np.int64)
AW = _R.uniform(0.5, 1.5, (4,)).astype(np.float32)
IDX2 = np.array([0, 2], np.int64)
# singular values 3, 1 and 0.1: rcond 0.2 drops the last
_Q4, _ = np.linalg.qr(_R.uniform(-1, 1, (4, 4)))
_Q3, _ = np.linalg.qr(_R.uniform(-1, 1, (3, 3)))
LS = ((_Q4[:, :3] * [3.0, 1.0, 0.1]) @ _Q3.T).astype(np.float32)


def _hh():
    return A, np.array([1.2, 0.7, 0.0], np.float32)


CASES = [
    # -- math
    ("bitwise_left_shift", lambda m, a, b: m.bitwise_left_shift(a, b),
     (I, SH)),
    ("bitwise_right_shift", lambda m, a, b: m.bitwise_right_shift(a, b),
     (I, SH)),
    ("copysign", lambda m, a, b: m.copysign(a, b), (X, Y)),
    ("count_nonzero", lambda m, a: m.count_nonzero(a, axis=1), (Z,)),
    ("count_nonzero_all", lambda m, a: m.count_nonzero(a), (Z,)),
    ("cumulative_trapezoid", lambda m, a: m.cumulative_trapezoid(a), (X,)),
    ("cumulative_trapezoid_x",
     lambda m, a, b: m.cumulative_trapezoid(a, x=b), (X, np.sort(V))),
    ("deg2rad", lambda m, a: m.deg2rad(a), (X,)),
    ("rad2deg", lambda m, a: m.rad2deg(a), (X,)),
    ("frac", lambda m, a: m.frac(a), (X * 3,)),
    ("neg", lambda m, a: m.neg(a), (X,)),
    ("sigmoid", lambda m, a: m.sigmoid(a), (X,)),
    ("sgn", lambda m, a: m.sgn(a), (X,)),
    ("mod", lambda m, a, b: m.mod(a, b), (X * 3, P)),
    ("floor_mod", lambda m, a, b: m.floor_mod(a, b), (I - 6, J)),
    ("frexp", lambda m, a: m.frexp(a), (X * 10,)),
    ("gcd", lambda m, a, b: m.gcd(a, b), (I, J)),
    ("lcm", lambda m, a, b: m.lcm(a, b), (I, J)),
    ("hypot", lambda m, a, b: m.hypot(a, b), (X, Y)),
    ("ldexp", lambda m, a, b: m.ldexp(a, b), (X, SH)),
    ("inner", lambda m, a, b: m.inner(a, b), (X, Y[:2])),
    ("inverse", lambda m, a: m.inverse(a), (SPD,)),
    ("mm", lambda m, a, b: m.mm(a, b), (X, A)),
    ("nan_to_num", lambda m, a: m.nan_to_num(a, nan=-1.0, posinf=9.0),
     (NAN,)),
    ("nanmean", lambda m, a: m.nanmean(a, axis=1), (NAN[:, :3],)),
    ("nansum", lambda m, a: m.nansum(a, axis=1), (NAN[:, :3],)),
    ("outer", lambda m, a, b: m.outer(a, b), (V, V[:3])),
    ("trapezoid", lambda m, a: m.trapezoid(a, dx=0.5), (X,)),
    ("vander", lambda m, a: m.vander(a, n=3), (V,)),
    ("vander_increasing", lambda m, a: m.vander(a, increasing=True), (V,)),
    ("diff", lambda m, a: m.diff(a, axis=0), (X,)),
    ("diff_prepend", lambda m, a, p, q: m.diff(a, n=2, prepend=p, append=q),
     (X, Y[:, :1], Y[:, 1:3])),
    ("sum_int", lambda m, a: m.sum(a, axis=0), (I,)),
    ("sum_bool", lambda m, a: m.sum(a), (MASK,)),
    # -- manipulation
    ("atleast_1d", lambda m, a, b: m.atleast_1d(a, b), (V[0], V)),
    ("atleast_2d", lambda m, a: m.atleast_2d(a), (V,)),
    ("atleast_3d", lambda m, a, b: m.atleast_3d(a, b), (V, X)),
    ("broadcast_shape", lambda m: m.broadcast_shape([3, 1], [1, 4]), ()),
    ("broadcast_to", lambda m, a: m.broadcast_to(a, [3, 4]), (V,)),
    ("chunk", lambda m, a: m.chunk(a, 2, axis=1), (X,)),
    ("dsplit", lambda m, a: m.dsplit(a, 2), (X3,)),
    ("hsplit", lambda m, a: m.hsplit(a, 2), (X,)),
    ("vsplit", lambda m, a: m.vsplit(a, 2), (A,)),
    ("tensor_split", lambda m, a: m.tensor_split(a, 3, axis=1), (X,)),
    ("dstack", lambda m, a, b: m.dstack([a, b]), (X, Y)),
    ("hstack", lambda m, a, b: m.hstack([a, b]), (X, Y)),
    ("vstack", lambda m, a, b: m.vstack([a, b]), (X, Y)),
    ("fill", lambda m, a: m.fill(a, 2.5), (X,)),
    ("fill_", lambda m, a: m.tensor.fill_(a, 2.5), (X,)),
    ("fill_diagonal_", lambda m, a: m.tensor.fill_diagonal_(a, 5.0),
     (SQ,)),
    ("fill_diagonal_wrap", lambda m, a: m.fill_diagonal(
        a, 5.0, wrap=True), (np.zeros((7, 3), np.float32),)),
    ("fill_diagonal_tensor", lambda m, a, b: m.fill_diagonal_tensor(
        a, b, offset=1), (X, V[:3])),
    ("fill_diagonal_tensor_", lambda m, a, b: m.tensor.fill_diagonal_tensor_(
        a, b), (X, V[:3])),
    ("moveaxis", lambda m, a: m.moveaxis(a, 0, 2), (X3,)),
    ("reshape_", lambda m, a: m.reshape_(a, [4, 3]), (X,)),
    ("squeeze_", lambda m, a: m.squeeze_(a, 1), (X[:, None],)),
    ("unsqueeze_", lambda m, a: m.unsqueeze_(a, [0, -1]), (X,)),
    ("reverse", lambda m, a: m.reverse(a, [0, 1]), (X,)),
    ("rot90", lambda m, a: m.rot90(a), (X,)),
    ("rot90_k2", lambda m, a: m.rot90(a, k=-1, axes=[1, 0]), (X,)),
    ("scatter_", lambda m, a, i, u: m.scatter_(a, i, u), (X, IDX2, Y[:2])),
    ("scatter_nd", lambda m, i, u: m.scatter_nd(i, u, [3, 4]),
     (np.array([[0, 1], [2, 3], [0, 1]], np.int64),
      np.array([1.0, 2.0, 3.0], np.float32))),
    ("take_clip", lambda m, a, i: m.take(a, i, mode="clip"),
     (X, np.array([[0, -1], [5, 20]], np.int64))),
    ("take_wrap", lambda m, a, i: m.take(a, i, mode="wrap"),
     (X, np.array([-13, 3, 25], np.int64))),
    ("t", lambda m, a: m.t(a), (X,)),
    ("t_vector", lambda m, a: m.t(a), (V,)),
    ("unflatten", lambda m, a: m.unflatten(a, 1, [2, -1]), (X,)),
    ("view", lambda m, a: m.view(a, [4, 3]), (X,)),
    ("view_dtype", lambda m, a: m.view(a, "int32"), (X,)),
    ("view_as", lambda m, a, b: m.view_as(a, b), (X, A)),
    ("masked_fill", lambda m, a, k: m.masked_fill(a, k, 0.5), (X, MASK)),
    ("masked_fill_tensor", lambda m, a, k, v: m.masked_fill(a, k, v),
     (X, MASK, np.float32(-2.0))),
    # -- logic
    ("is_empty", lambda m, a: m.is_empty(a), (X,)),
    ("is_empty_0", lambda m, a: m.is_empty(a),
     (np.zeros((0, 3), np.float32),)),
    ("is_tensor", lambda m, a: (m.is_tensor(a), m.is_tensor(X)), (X,)),
    ("isin", lambda m, a, b: m.isin(a, b), (I, J[0])),
    ("isin_invert", lambda m, a, b: m.isin(a, b, invert=True), (I, J[0])),
    # -- search
    ("bucketize", lambda m, a, s: m.bucketize(a, s), (X, SEQ)),
    ("bucketize_right", lambda m, a, s: m.bucketize(a, s, right=True),
     (X, SEQ)),
    ("sort", lambda m, a: m.sort(a, axis=1, descending=True), (TIES,)),
    ("index_fill", lambda m, a, i: m.index_fill(a, i, 1, -1.0), (X, IDX2)),
    ("where_", lambda m, c, a, b: m.where_(c, a, b), (MASK, X, Y)),
    ("argsort_ties", lambda m, a: m.argsort(a, axis=1), (TIES,)),
    ("argsort_ties_descending",
     lambda m, a: m.argsort(a, axis=1, descending=True), (TIES,)),
    ("topk_ties", lambda m, a: m.topk(a, 2), (TIES,)),
    ("topk_ties_smallest", lambda m, a: m.topk(a, 3, largest=False),
     (TIES,)),
    ("topk_axis0", lambda m, a: m.topk(a, 2, axis=0), (X,)),
    ("kthvalue_ties", lambda m, a: m.kthvalue(a, 2), (TIES,)),
    ("kthvalue_keepdim", lambda m, a: m.kthvalue(a, 3, axis=0,
                                                 keepdim=True), (X,)),
    ("mode_ties", lambda m, a: m.mode(a), (TIES,)),
    ("mode_axis0", lambda m, a: m.mode(a, axis=0, keepdim=True),
     (np.array([[1, 2], [3, 2], [1, 4]], np.float32),)),
    ("argmax_int32", lambda m, a: m.argmax(a, axis=1), (X,)),
    ("argmax_keepdim", lambda m, a: m.argmax(a, keepdim=True), (X,)),
    ("nonzero", lambda m, a: m.nonzero(a), (Z,)),
    ("nonzero_tuple", lambda m, a: m.nonzero(a, as_tuple=True), (Z,)),
    ("unique", lambda m, a: m.unique(a, return_index=True,
                                     return_inverse=True,
                                     return_counts=True), (I,)),
    ("unique_axis", lambda m, a: m.unique(a, return_inverse=True, axis=0),
     (np.array([[1, 2], [0, 1], [1, 2]], np.int64),)),
    ("unique_consecutive", lambda m, a: m.unique_consecutive(
        a, return_inverse=True, return_counts=True),
     (np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64),)),
    # -- stat
    ("std", lambda m, a: m.std(a, axis=1), (X,)),
    ("std_all", lambda m, a: m.std(a, unbiased=False), (X,)),
    ("var", lambda m, a: m.var(a, axis=[0, 1], keepdim=True), (X,)),
    ("quantile", lambda m, a: m.quantile(a, [0.25, 0.5], axis=1,
                                         keepdim=True), (X,)),
    ("quantile_all", lambda m, a: m.quantile(a, 0.3), (X,)),
    ("nanquantile", lambda m, a: m.nanquantile(a, 0.4, axis=1),
     (NAN[:, :3],)),
    ("median_avg", lambda m, a: m.median(a),
     (np.array([1, 2, 3, 4], np.float32),)),
    ("median_axis", lambda m, a: m.median(a, axis=1, keepdim=True), (X,)),
    ("median_min", lambda m, a: m.median(a, axis=1, mode="min"), (X,)),
    ("nanmedian", lambda m, a: m.nanmedian(a, axis=1), (NAN[:, :3],)),
    ("histogramdd", lambda m, a: m.histogramdd(a, bins=4), (PTS,)),
    ("histogram", lambda m, a: m.histogram(a, bins=5), (X,)),
    ("histogram_range", lambda m, a: m.histogram(a, bins=4, min=-0.5,
                                                 max=0.5), (X,)),
    ("bincount", lambda m, a: m.bincount(a, minlength=14), (I[0],)),
    ("corrcoef", lambda m, a: m.corrcoef(a), (X,)),
    ("cov", lambda m, a: m.cov(a, rowvar=False, ddof=False), (X,)),
    ("cov_weights", lambda m, a, f, w: m.cov(a, fweights=f, aweights=w),
     (X, W, AW)),
    # -- linalg
    ("cdist", lambda m, a, b: m.cdist(a, b), (A, B)),
    ("cdist_p1", lambda m, a, b: m.cdist(a, b, p=1.0), (A, B)),
    ("cond", lambda m, a: m.linalg.cond(a), (SPD,)),
    ("linalg_corrcoef", lambda m, a: m.linalg.corrcoef(a), (X,)),
    ("linalg_cov", lambda m, a, f, w: m.linalg.cov(a, fweights=f,
                                                   aweights=w), (X, W, AW)),
    ("householder_product",
     lambda m, a, t: m.linalg.householder_product(a, t), _hh()),
    ("lu_unpack", lambda m, a: m.linalg.lu_unpack(*m.linalg.lu(a)), (SQ,)),
    ("lstsq_rcond", lambda m, a, b: m.linalg.lstsq(a, b, rcond=0.2),
     (LS, A[:, :2])),
    ("matmul_transpose", lambda m, a, b: m.linalg.matmul_transpose(a, b),
     (X, Y)),
    ("matrix_norm", lambda m, a: m.linalg.matrix_norm(a), (X,)),
    ("matrix_norm_nuc", lambda m, a: m.linalg.matrix_norm(a, p="nuc"),
     (X,)),
    ("pinv", lambda m, a: m.linalg.pinv(a), (A,)),
    ("svdvals", lambda m, a: m.linalg.svdvals(a), (A,)),
    ("tensordot", lambda m, a, b: m.tensordot(a, b, axes=1), (X, A)),
    ("tensordot_pairs", lambda m, a, b: m.tensordot(a, b, axes=[[1], [1]]),
     (X, Y)),
    ("vector_norm", lambda m, a: m.linalg.vector_norm(a, p=3.0, axis=1),
     (X,)),
    ("vector_norm_all", lambda m, a: m.linalg.vector_norm(a), (X,)),
    # -- creation and the dtype rules
    ("clone", lambda m, a: m.clone(a), (X,)),
    ("diagflat", lambda m, a: m.diagflat(a, 1), (V,)),
    ("polar", lambda m, a, b: m.polar(a, b), (P, X)),
    ("arange_int", lambda m: m.arange(5), ()),
    ("arange_float", lambda m: m.arange(0, 1, 0.25), ()),
    ("full_int", lambda m: m.full([2], 3), ()),
    ("full_bool", lambda m: m.full([2], True), ()),
    ("full_float", lambda m: m.full([2, 2], 1.5), ()),
    ("zeros_int64", lambda m: m.zeros([2], dtype="int64"), ()),
    ("empty_like", lambda m, a: m.empty_like(a), (X,)),
]


def call_inplace(m, name, to):
    """``m.<name>_`` (an in-place variant) on a fresh ``x`` made from
    ``P`` by ``to``, with its other arguments; returns ``(x, result)``."""
    args = {  # the arguments after x, tensors given as numpy
        "addmm": (P, np.eye(4, dtype=np.float32)),
        "index_add": (IDX2, 0, P[:2]),
        "index_put": ((IDX2, np.array([1, 3], np.int64)), np.float32(5.0)),
        "polygamma": (1,), "pow": (2.0,), "clip": (0.3, 0.6),
        "scale": (2.0, 0.5), "add": (Y,), "subtract": (Y,),
        "multiply": (Y,), "divide": (P,), "tril": (1,), "triu": (-1,),
    }.get(name, ())

    def conv(a):
        if isinstance(a, tuple):
            return tuple(conv(v) for v in a)
        return to(a) if isinstance(a, np.ndarray) or isinstance(
            a, np.generic) else a
    x = to(P)
    return x, getattr(m, name + "_")(x, *[conv(a) for a in args])


N = 20000


def draw(m, name, dev="cpu"):
    """A call that draws ``name`` from ``m`` on ``dev`` (the ops without a
    tensor input draw on the current device), and the draw's expected
    mean and variance."""
    s = (N,)

    def full(v):
        return torch.full(s, v, device=dev)
    draws = {
        "uniform": (lambda: m.uniform(s, min=-2.0, max=3.0), 0.5,
                    25 / 12),
        "rand": (lambda: m.rand(s), 0.5, 1 / 12),
        "randn": (lambda: m.randn(s), 0.0, 1.0),
        "standard_normal": (lambda: m.standard_normal(s), 0.0, 1.0),
        "normal": (lambda: m.normal(1.5, 2.0, s), 1.5, 4.0),
        "gaussian": (lambda: m.tensor.gaussian(
            full(-1.0), full(0.5)), -1.0, 0.25),
        "randint": (lambda: m.randint(2, 12, s), 6.5, (100 - 1) / 12),
        "randint_like": (lambda: m.randint_like(
            torch.zeros(s, dtype=torch.int32, device=dev), 0, 4), 1.5, 15 / 12),
        "randperm": (lambda: m.randperm(N), (N - 1) / 2,
                     (N * N - 1) / 12),
        "shuffle": (lambda: m.tensor.shuffle(
            torch.arange(N, dtype=torch.float32, device=dev)), (N - 1) / 2,
            (N * N - 1) / 12),
        "multinomial": (lambda: m.multinomial(
            torch.tensor([1.0, 2.0, 1.0], device=dev), N, replacement=True), 1.0, 0.5),
        "bernoulli": (lambda: m.bernoulli(full(0.3)), 0.3, 0.21),
        "bernoulli_": (lambda: m.tensor.bernoulli_(torch.zeros(s, device=dev), 0.7),
                       0.7, 0.21),
        "poisson": (lambda: m.tensor.poisson(full(3.0)), 3.0,
                    3.0),
        "binomial": (lambda: m.tensor.binomial(
            full(10), full(0.4)), 4.0, 2.4),
        "exponential_": (lambda: m.tensor.exponential_(torch.zeros(s, device=dev),
                                                         2.0), 0.5, 0.25),
        "uniform_": (lambda: m.tensor.uniform_(torch.zeros(s, device=dev), 0.0, 2.0),
                     1.0, 1 / 3),
        "normal_": (lambda: m.tensor.normal_(torch.zeros(s, device=dev), 2.0, 3.0),
                    2.0, 9.0),
        "rand_like": (lambda: m.tensor.rand_like(torch.zeros(s, device=dev)), 0.5,
                      1 / 12),
        "randn_like": (lambda: m.tensor.randn_like(torch.zeros(s, device=dev)), 0.0,
                       1.0),
    }
    return draws[name]


RANDOM = ["uniform", "rand", "randn", "standard_normal", "normal",
          "gaussian", "randint", "randint_like", "randperm", "shuffle",
          "multinomial", "bernoulli", "bernoulli_", "poisson", "binomial",
          "exponential_", "uniform_", "normal_", "rand_like", "randn_like"]
# every statistic is an average of N draws: 6 standard errors apart is
# a 2e-9 chance
SIGMAS = 6.0
PCA = np.random.RandomState(4).uniform(-1, 1, (6, 4)).astype(np.float32)


def pca(m, a):
    """``pca_lowrank`` at full rank (held by its invariants)."""
    return m.linalg.pca_lowrank(a, q=4)


# -- the op specs in the tensor namespace ----------------------------------------

TENSOR_MODULES = ("math", "manipulation", "linalg", "creation", "random",
                  "logic", "search", "stat", "einsum")


def tensor_specs(specs, names):
    """The names of the specs of ``tests/op_specs.py`` whose callable lies
    in the tensor namespace: ``paddle_tpu.<name>`` for a tensor function
    in ``names``, ``paddle_tpu.linalg.*`` and ``paddle_tpu.tensor.*``."""
    def inside(path):
        parts = path.split(".")
        return ((len(parts) == 2 and parts[1] in names) or path.startswith(
            ("paddle_tpu.linalg.", "paddle_tpu.tensor.")))
    return sorted(n for n, s in specs.items() if inside(s["path"]))


def resolve(root, path):
    """``path`` (``paddle_tpu.a.b``) looked up from the package ``root``."""
    obj = root
    for p in path.split(".")[1:]:
        obj = getattr(obj, p)
    return obj


def spec_inputs(to, inputs):
    """A spec's numpy inputs through ``to`` (lists element by element)."""
    return [[to(np.asarray(v)) for v in x] if isinstance(x, (list, tuple))
            else to(np.asarray(x)) for x in inputs]


def _port_lu_recon(f):
    def run(x):
        lu, piv = f(x)
        pm, lo, up = ptt.linalg.lu_unpack(lu, piv)
        return pm @ lo @ up
    return run


def _port_svd_recon(f):
    def run(x):
        u, s, vh = f(x)
        return (u * s.unsqueeze(-2)) @ vh
    return run


# adapters of op_specs.py that import the reference, and their twins for
# the port
PORT_ADAPTERS = {"_lu_recon": _port_lu_recon, "_svd_recon": _port_svd_recon}


def _reaches_reference(fn, seen=None):
    """Whether ``fn``'s code, or a function of its module that it names,
    imports or names ``paddle_tpu``."""
    seen = set() if seen is None else seen
    if fn in seen:
        return False
    seen.add(fn)
    codes, names = [fn.__code__], set()
    while codes:
        code = codes.pop()
        names |= set(code.co_names)
        codes += [c for c in code.co_consts if isinstance(c, types.CodeType)]
    if "paddle_tpu" in names:
        return True
    return any(_reaches_reference(g, seen) for g in (
        fn.__globals__.get(n) for n in names)
        if isinstance(g, types.FunctionType))


def port_adapted(spec, root=ptt):
    """The port's callable of ``spec`` (looked up from ``root``) with its
    adapter applied. An adapter that reaches the reference must have a
    twin in ``PORT_ADAPTERS``: it raises ``LookupError`` otherwise."""
    fn = resolve(root, spec["path"])
    adapter = spec["adapter"]
    if adapter is None:
        return fn
    twin = PORT_ADAPTERS.get(adapter.__name__)
    if twin is not None:
        return twin(fn)
    if _reaches_reference(adapter):
        raise LookupError(f"the adapter {adapter.__name__} of "
                          f"{spec['path']} reaches the reference and has "
                          f"no twin in PORT_ADAPTERS")
    return adapter(fn)


# -- what the rows call ------------------------------------------------------------


class Recorder:
    """``m`` (the port or one of its namespaces) noting, in ``seen``,
    each ``(name, function)`` resolved on it, in order."""

    def __init__(self, m, seen=None):
        self._m = m
        self.seen = [] if seen is None else seen

    def __getattr__(self, name):
        obj = getattr(self._m, name)
        if isinstance(obj, types.ModuleType):
            return Recorder(obj, self.seen)
        self.seen.append((name, obj))
        return obj


def module_of(seen):
    """The port module (``math``, ``linalg``, ...) of the first tensor
    function in a recorder's ``seen`` (an in-place variant counts as its
    base)."""
    for name, obj in seen:
        if name.endswith("_") and name[:-1] in ptt.INPLACE:
            obj = getattr(ptt.tensor, name[:-1])
        mod = getattr(obj, "__module__", "") or ""
        if mod.startswith("paddle_tpu_torch.tensor."):
            return mod.rsplit(".", 1)[1]
    raise LookupError(f"no tensor function among {[n for n, _ in seen]}")


def cpu_tensor(a):
    return ptt.to_tensor(np.array(a), place="cpu")


@functools.cache
def covered():
    """The names of the tensor functions that the ``CASES`` rows, the
    in-place variants, the random draws (after their seed) and
    :func:`pca` call, as a recorder of the port sees them on the CPU."""
    rec = Recorder(ptt)
    with using_device("cpu"):
        for _, call, inputs in CASES:
            call(rec, *[cpu_tensor(a) for a in inputs])
        for name in ptt.INPLACE:
            call_inplace(rec, name, cpu_tensor)
        for name in RANDOM:
            rec.seed(5)
            draw(rec, name)[0]()
        pca(rec, cpu_tensor(PCA))
    return frozenset(name for name, _ in rec.seen)
