"""Elementwise, matrix-product and reduction ops (counterpart of
``paddle_tpu/tensor/math.py``).

Each op casts its inputs by ``amp.auto_cast``'s policy under its Paddle
name before it computes (white: the matrix products; black: ``exp``,
``log``, ``sum``, ``mean``, ...; every other op gray), and gives the
reference's dtypes: an integer reduction stays int32, an index int32.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from ._common import (
    axes, canon, dtype_of, float_of, promote, scalar, tensors,
)


def _op(name, *xs):
    return cast_inputs(name, *tensors(*xs))


def _unary(name, fn):
    def f(x, name=None):
        (a,) = _op(f.__op_name__, x)
        return canon(fn(a))
    f.__name__ = f.__qualname__ = name
    f.__op_name__ = name
    f.__doc__ = f"Elementwise {name} (``paddle.{name}``)."
    return f


def _binary(name, fn):
    def f(x, y, name=None):
        a, b = _op(f.__op_name__, x, y)
        return canon(fn(a, b))
    f.__name__ = f.__qualname__ = name
    f.__op_name__ = name
    f.__doc__ = (f"Elementwise {name} with broadcasting "
                 f"(``paddle.{name}``).")
    return f


def _same(fn):
    """``fn`` on its two inputs promoted to one dtype."""
    return lambda a, b: fn(*promote(a, b))


def _imag(a):
    return a.imag if a.is_complex() else torch.zeros_like(a)


# ---- elementwise unary ----
abs = _unary("abs", torch.abs)  # noqa: A001
acos = _unary("acos", torch.acos)
acosh = _unary("acosh", torch.acosh)
asin = _unary("asin", torch.asin)
asinh = _unary("asinh", torch.asinh)
atan = _unary("atan", torch.atan)
atanh = _unary("atanh", torch.atanh)
ceil = _unary("ceil", torch.ceil)
cos = _unary("cos", torch.cos)
cosh = _unary("cosh", torch.cosh)
digamma = _unary("digamma", lambda a: torch.special.digamma(float_of(a)))
erf = _unary("erf", lambda a: torch.erf(float_of(a)))
erfinv = _unary("erfinv", lambda a: torch.erfinv(float_of(a)))
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
floor = _unary("floor", torch.floor)
frac = _unary("frac", lambda a: a - torch.trunc(a))
i0 = _unary("i0", lambda a: torch.special.i0(float_of(a)))
lgamma = _unary("lgamma", lambda a: torch.lgamma(float_of(a)))
log = _unary("log", torch.log)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
log2 = _unary("log2", torch.log2)
neg = _unary("neg", torch.neg)
reciprocal = _unary("reciprocal", lambda a: torch.reciprocal(float_of(a)))
round = _unary("round", torch.round)  # noqa: A001
rsqrt = _unary("rsqrt", torch.rsqrt)
sigmoid = _unary("sigmoid", lambda a: torch.sigmoid(float_of(a)))
sign = _unary("sign", torch.sgn)
sin = _unary("sin", torch.sin)
sinh = _unary("sinh", torch.sinh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
tan = _unary("tan", torch.tan)
tanh = _unary("tanh", torch.tanh)
trunc = _unary("trunc", torch.trunc)
deg2rad = _unary("deg2rad", lambda a: torch.deg2rad(float_of(a)))
rad2deg = _unary("rad2deg", lambda a: torch.rad2deg(float_of(a)))
angle = _unary("angle", lambda a: torch.angle(float_of(a)))
conj = _unary("conj", lambda a: torch.conj(a).resolve_conj())
real = _unary("real", torch.real)
imag = _unary("imag", _imag)

# ---- elementwise binary ----
add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary("pow", torch.pow)  # noqa: A001
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
heaviside = _binary("heaviside", _same(torch.heaviside))
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
hypot = _binary("hypot", _same(torch.hypot))
logaddexp = _binary("logaddexp", _same(torch.logaddexp))
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", _same(torch.nextafter))
ldexp = _binary("ldexp",
                lambda a, b: a * torch.pow(2.0, b.to(torch.float32)))

# bitwise
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_not = _unary("bitwise_not", torch.bitwise_not)
bitwise_left_shift = _binary("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _binary("bitwise_right_shift",
                              torch.bitwise_right_shift)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``), then the
    activation ``act`` of ``nn.functional`` by name."""
    (a,) = _op("scale", x)
    b = torch.tensor(bias, dtype=a.dtype, device=a.device)
    out = canon(a * scale + b if bias_after_scale else (a + b) * scale)
    if act is not None:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def clip(x, min=None, max=None, name=None):  # noqa: A002
    (a,) = _op("clip", x)
    lo, hi = scalar(min), scalar(max)
    if lo is None and hi is None:
        return canon(a)
    return canon(torch.clamp(a, lo, hi))


def lerp(x, y, weight, name=None):
    if isinstance(weight, torch.Tensor):
        a, b, w = _op("lerp", x, y, weight)
    else:
        (a, b), w = _op("lerp", x, y), weight
    return canon(a + w * (b - a))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    (a,) = _op("stanh", x)
    return canon(scale_b * torch.tanh(scale_a * a))


def multiplex(inputs, index, name=None):
    """Row ``i`` from ``inputs[index[i]]``."""
    arrs = _op("multiplex", *inputs)
    (idx,) = tensors(index)
    stacked = torch.stack(arrs, 0)
    sel = idx.reshape(-1).long().to(stacked.device)
    return canon(stacked[sel, torch.arange(sel.shape[0],
                                           device=stacked.device)])


# ---- matmul family ----
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y`` with optional transposes of the last two dims (white)."""
    x, y = _op("matmul", x, y)
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return canon(torch.matmul(x, y))


def dot(x, y, name=None):
    a, b = _op("dot", x, y)
    return canon(torch.sum(a * b, -1))


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    a, b = _op("bmm", x, y)
    return canon(torch.matmul(a, b))


def mv(x, vec, name=None):
    a, b = _op("mv", x, vec)
    return canon(torch.matmul(a, b))


def inner(x, y, name=None):
    a, b = _op("inner", x, y)
    return canon(torch.tensordot(a, b, ([-1], [-1])))


def outer(x, y, name=None):
    a, b = _op("outer", x, y)
    return canon(torch.outer(a.reshape(-1), b.reshape(-1)))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    i, a, b = _op("addmm", input, x, y)
    return canon(beta * i + alpha * torch.matmul(a, b))


def kron(x, y, name=None):
    a, b = _op("kron", x, y)
    return canon(torch.kron(a, b))


def cross(x, y, axis=9, name=None):
    """The cross product along ``axis`` (by default the first dim of
    size 3)."""
    a, b = _op("cross", x, y)
    ax = axis
    if ax == 9:
        ax = next(i for i, d in enumerate(a.shape) if d == 3)
    return canon(torch.linalg.cross(a, b, dim=ax))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    (a,) = _op("trace", x)
    return canon(torch.diagonal(a, offset, axis1, axis2).sum(-1,
                                                              dtype=a.dtype))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    (a,) = _op("diagonal", x)
    return canon(torch.diagonal(a, offset, axis1, axis2))


# ---- reductions ----
def _dims(a, axis):
    return axes(axis, a.dim())


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    """The sum over ``axis``; an integer or bool input sums to int32, as
    in the reference (torch's would be int64)."""
    (a,) = _op("sum", x)
    d = dtype_of(dtype) if dtype else None
    if a.dtype == torch.bool and d is None:
        d = torch.int32
    return canon(torch.sum(a, _dims(a, axis), keepdim=keepdim, dtype=d))


def mean(x, axis=None, keepdim=False, name=None):
    (a,) = _op("mean", x)
    return canon(torch.mean(float_of(a), _dims(a, axis), keepdim=keepdim))


def _extreme(name, fn, x, axis, keepdim):
    (a,) = _op(name, x)
    return canon(fn(a, _dims(a, axis), keepdim=keepdim) if a.dim() else a)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _extreme("max", torch.amax, x, axis, keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return _extreme("min", torch.amin, x, axis, keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    (a,) = _op("prod", x)
    if dtype:
        a = a.to(dtype_of(dtype))
    for d in sorted(_dims(a, axis), reverse=True):
        a = torch.prod(a, d, keepdim=keepdim)
    return canon(a)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    (a,) = _op("nansum", x)
    d = dtype_of(dtype) if dtype else None
    return canon(torch.nansum(a, _dims(a, axis), keepdim=keepdim, dtype=d))


def nanmean(x, axis=None, keepdim=False, name=None):
    (a,) = _op("nanmean", x)
    return canon(torch.nanmean(float_of(a), _dims(a, axis),
                               keepdim=keepdim))


def logsumexp(x, axis=None, keepdim=False, name=None):
    (a,) = _op("logsumexp", x)
    return canon(torch.logsumexp(float_of(a), _dims(a, axis),
                                 keepdim=keepdim))


def cumsum(x, axis=None, dtype=None, name=None):
    (a,) = _op("cumsum", x)
    d = dtype_of(dtype) if dtype else None
    if axis is None:
        return canon(torch.cumsum(a.reshape(-1), 0, dtype=d))
    return canon(torch.cumsum(a, int(axis), dtype=d))


def cumprod(x, dim=None, dtype=None, name=None):
    (a,) = _op("cumprod", x)
    d = dtype_of(dtype) if dtype else None
    if dim is None:
        return canon(torch.cumprod(a.reshape(-1), 0, dtype=d))
    return canon(torch.cumprod(a, dim, dtype=d))


def _cum_extreme(name, fn, x, axis):
    (a,) = _op(name, x)
    if axis is None:
        a, axis = a.reshape(-1), 0
    vals, idx = fn(a, int(axis))
    return canon(vals), idx.to(torch.int32)


def cummax(x, axis=None, dtype="int64", name=None):
    """The running maximum and the index it came from (the last of
    equal values, as the reference's scan keeps), int32."""
    return _cum_extreme("cummax", torch.cummax, x, axis)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme("cummin", torch.cummin, x, axis)


def logcumsumexp(x, axis=None, name=None):
    (a,) = _op("logcumsumexp", x)
    if axis is None:
        a, axis = a.reshape(-1), 0
    return canon(torch.logcumsumexp(float_of(a), int(axis)))


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        return inputs
    arrs = _op("add_n", *inputs)
    out = arrs[0]
    for a in arrs[1:]:
        out = out + a
    return canon(out)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    (a,) = tensors(x)
    return torch.sum(a != 0, _dims(a, axis), keepdim=keepdim,
                     dtype=torch.int32)


# ---- float status ----
def isnan(x, name=None):
    return torch.isnan(tensors(x)[0])


def isinf(x, name=None):
    return torch.isinf(tensors(x)[0])


def isfinite(x, name=None):
    return torch.isfinite(tensors(x)[0])


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    (a,) = _op("nan_to_num", x)
    return canon(torch.nan_to_num(a, nan, posinf, neginf))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    a, pre, app = _op("diff", x, prepend, append)
    ax = axis % a.dim()

    def along(t):
        if t is None or t.dim() == a.dim():
            return t
        shape = list(a.shape)
        shape[ax] = 1
        return t.reshape(-1 if t.dim() else 1).expand(shape) \
            if t.numel() == 1 else t
    return canon(torch.diff(a, n, ax, along(pre), along(app)))


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    return x.add_(value)


# ---- round-3 op-coverage additions ----
i0e = _unary("i0e", lambda a: torch.special.i0e(float_of(a)))
i1 = _unary("i1", lambda a: torch.special.i1(float_of(a)))
i1e = _unary("i1e", lambda a: torch.special.i1e(float_of(a)))


def logit(x, eps=None, name=None):
    """``log(x / (1 - x))``, x clamped into ``[eps, 1 - eps]`` first
    when ``eps`` is given."""
    (a,) = _op("logit", x)
    if eps is not None:
        a = torch.clamp(a, eps, 1.0 - eps)
    return canon(torch.log(a) - torch.log1p(-a))


def polygamma(x, n, name=None):
    """The ``n``-th derivative of digamma."""
    if n < 0:
        raise ValueError(f"polygamma order must be >= 0, got {n}")
    if n == 0:
        return digamma(x)
    (a,) = _op("polygamma", x)
    return canon(torch.special.polygamma(n, float_of(a)))


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled so that its p-norm is at most
    ``max_norm`` (``max_norm / max(norm, 1e-12)``, as the reference)."""
    (a,) = _op("renorm", x)
    red = tuple(i for i in range(a.dim()) if i != axis % a.dim())
    norms = torch.sum(torch.abs(a) ** p, red, keepdim=True) ** (1.0 / p)
    f = torch.where(norms > max_norm,
                    max_norm / torch.clamp_min(norms, 1e-12),
                    torch.ones_like(norms))
    return canon(a * f)


def inverse(x, name=None):
    (a,) = _op("inverse", x)
    return canon(torch.linalg.inv(a))


def clip_by_norm(x, max_norm, name=None):
    """``x`` scaled so that its global L2 norm (in fp32) is at most
    ``max_norm``."""
    (a,) = _op("clip_by_norm", x)
    norm2 = torch.sqrt(torch.sum(a.to(torch.float32) ** 2))
    f = torch.where(norm2 > max_norm,
                    max_norm / torch.clamp_min(norm2, 1e-12),
                    torch.ones_like(norm2))
    return canon(a * f.to(a.dtype))


def squared_l2_norm(x, name=None):
    """``sum(x ** 2)`` in fp32, 0-d."""
    (a,) = _op("squared_l2_norm", x)
    return torch.sum(torch.square(a.to(torch.float32)))


def frobenius_norm(x, axis=None, keepdim=False, name=None):
    (a,) = _op("frobenius_norm", x)
    return canon(torch.sqrt(torch.sum(torch.square(a), _dims(a, axis),
                                      keepdim=keepdim)))


def sgn(x, name=None):
    """The sign of a real input; ``x / |x|`` (0 at 0) of a complex one."""
    (a,) = _op("sgn", x)
    return canon(torch.sgn(a))


def frexp(x, name=None):
    """Mantissa in [0.5, 1) and int32 exponent with ``x = m * 2 ** e``."""
    (a,) = _op("frexp", x)
    m, e = torch.frexp(float_of(a))
    return canon(m), e.to(torch.int32)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None and dx is not None:
        raise ValueError("trapezoid accepts x or dx, not both")
    ya, xa = _op("trapezoid", y, x)
    if xa is not None:
        return canon(torch.trapezoid(ya, xa, dim=axis))
    return canon(torch.trapezoid(ya, dx=1.0 if dx is None else dx, dim=axis))


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """The running trapezoidal integral along ``axis``: entry i is the
    integral over the first i + 2 samples."""
    if x is not None and dx is not None:
        raise ValueError("cumulative_trapezoid accepts x or dx, not both")
    ya, xa = _op("cumulative_trapezoid", y, x)
    ax = axis % ya.dim()
    n = ya.shape[ax]
    pair = (ya.narrow(ax, 1, n - 1) + ya.narrow(ax, 0, n - 1)) / 2.0
    if xa is not None:
        if xa.dim() == 1:
            shape = [1] * ya.dim()
            shape[ax] = -1
            xa = xa.reshape(shape)
        m = xa.shape[ax]
        step = xa.narrow(ax, 1, m - 1) - xa.narrow(ax, 0, m - 1)
    else:
        step = 1.0 if dx is None else dx
    return canon(torch.cumsum(pair * step, ax))


def vander(x, n=None, increasing=False, name=None):
    """The Vandermonde matrix of a 1-D tensor (decreasing powers by
    default)."""
    (a,) = _op("vander", x)
    cols = a.shape[0] if n is None else int(n)
    out = torch.linalg.vander(a, N=cols)
    return canon(out if increasing else torch.flip(out, [-1]))

