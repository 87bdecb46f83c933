"""Normalization (counterpart of ``paddle_tpu/nn/functional/norm.py``).

The reference computes each as ``jnp`` expressions under ``apply``, which
XLA fuses: no Pallas kernel. ``batch_norm`` is torch's op (cuDNN on the
card); ``group_norm``, ``instance_norm`` and ``local_response_norm`` are
the reference's formulas in torch ops, in the input's dtype after
``amp.auto_cast``'s cast by their op names."""
from __future__ import annotations

import torch

from ...amp.auto_cast import cast_inputs

__all__ = ["rms_norm", "layer_norm", "batch_norm", "group_norm",
           "instance_norm", "local_response_norm"]


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last dim: the mean square in fp32, ``rsqrt``, a
    cast back to x's dtype, then ``* weight``. The training forward and
    the decode path (``models/generation.py``, ``serving/engine.py``)
    share this one copy. A black op under ``auto_cast``: x and weight in
    fp32."""
    x, weight = cast_inputs("rms_norm", x, weight)
    x32 = x.to(torch.float32)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    return out if weight is None else out * weight


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` dims, computed in
    x's dtype as the reference computes it (``norm.py:112-121``): the
    mean and the (biased) variance are reduced in fp32 and rounded to x's
    dtype (``jnp.mean`` and ``jnp.var`` upcast bf16 for the sum), then
    ``(x - mean) / sqrt(var + epsilon) * weight + bias`` in x's dtype.
    Under O2 bf16 that is bf16 arithmetic, not the fp32 inside
    ``torch.nn.functional.layer_norm``. A black op under ``auto_cast``."""
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.dim() - len(normalized_shape), x.dim()))
    x32 = x.to(torch.float32)
    mean = x32.mean(dims, keepdim=True)
    var = x32.var(dims, unbiased=False, keepdim=True)
    out = (x - mean.to(x.dtype)) / torch.sqrt(var.to(x.dtype) + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch normalization over every dim but the channel dim (dim 1, or
    the last for ``NLC``/``NHWC``/``NDHWC``), returned in x's dtype.

    While ``training`` (and not ``use_global_stats``) the batch's
    statistics normalize and the running buffers are updated in place
    by Paddle's rule (``norm.py:43-58``): ``running = momentum * running
    + (1 - momentum) * batch``, the variance unbiased (``n / (n - 1)``,
    ``n = numel / C``). Torch's ``momentum`` weights the new value, so
    ``1 - momentum`` is passed; its running variance is the unbiased one
    too. Otherwise the running statistics normalize.

    It computes through ``torch.nn.functional.batch_norm`` (cuDNN's or
    torch's own kernels on the card, the update inside the op, so a CUDA
    graph replays it) with the scale and shift cast to fp32 for bf16 or
    fp16 input: torch refuses a bf16 weight beside fp32 running buffers,
    and takes bf16 or fp16 input with fp32 parameters, whose statistics
    and normalization it computes in fp32. The reference computes in x's
    dtype (under O2: bf16 batch statistics and bf16 arithmetic), so the
    two agree to bf16's rounding there and to fp32's in fp32. A black op
    under ``auto_cast``: x in fp32 and the output cast back to the
    caller's dtype, as the reference casts it.

    With one value per channel (``n == 1``, decided from the shape) in
    training, torch's op refuses; the reference's rule runs instead, in
    plain torch ops that a CUDA graph captures: the output is the shift,
    the running mean moves toward the batch's, and the running variance
    toward 0 (``n / max(n - 1, 1)`` of a zero variance)."""
    orig = x.dtype
    x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    channel_last = data_format in ("NLC", "NHWC", "NDHWC")
    if channel_last:
        x = x.movedim(-1, 1)
    if training and not use_global_stats and x.numel() == x.shape[1]:
        out = _batch_norm_single(x, running_mean, running_var, weight, bias,
                                 momentum, epsilon)
        return (out.movedim(1, -1) if channel_last else out).to(orig)
    pdt = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype
    weight, bias = (None if t is None else t.to(pdt) for t in (weight, bias))
    out = torch.nn.functional.batch_norm(
        x, running_mean, running_var, weight, bias,
        training=bool(training and not use_global_stats),
        momentum=1.0 - momentum, eps=epsilon)
    if channel_last:
        out = out.movedim(1, -1)
    return out.to(orig)


def _batch_norm_single(x, running_mean, running_var, weight, bias, momentum,
                       epsilon):
    """Train-mode batch norm of channel-first ``x`` with one value per
    channel, by the reference's formula (``norm.py:43-58, 80-90``): the
    batch variance is 0, so the output is ``bias`` (0 without one) and
    the gradient reaches only the shift."""
    shape = [1] * x.dim()
    shape[1] = -1
    mean = x.mean(dim=[d for d in range(x.dim()) if d != 1])
    out = (x - mean.reshape(shape)) / torch.sqrt(
        torch.zeros_like(mean).reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    with torch.no_grad():
        if running_mean is not None:
            running_mean.mul_(momentum).add_(
                (1 - momentum) * mean.detach().to(running_mean.dtype))
        if running_var is not None:
            running_var.mul_(momentum)
    return out


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW", name=None):
    """Normalizes each of ``num_groups`` runs of channels over the run
    and the spatial dims (biased variance), then the per-channel scale
    and shift."""
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    channel_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channel_last else x
    n, c = a.shape[:2]
    g = a.reshape(n, num_groups, c // num_groups, *a.shape[2:])
    dims = tuple(range(2, g.dim()))
    mean = g.mean(dims, keepdim=True)
    var = g.var(dims, unbiased=False, keepdim=True)
    out = ((g - mean) / torch.sqrt(var + epsilon)).reshape(a.shape)
    out = _affine(out, weight, bias, (1, c) + (1,) * (a.dim() - 2))
    return out.movedim(1, -1) if channel_last else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Normalizes each (sample, channel) over its spatial dims; with
    ``use_input_stats=False`` and running statistics given, by those
    instead (``norm.py:183``). As in the reference the running
    statistics are read, never updated (``momentum`` is accepted)."""
    x, running_mean, running_var, weight, bias = cast_inputs(
        "instance_norm", x, running_mean, running_var, weight, bias)
    channel_last = not data_format.startswith("NC")
    a = x.movedim(-1, 1) if channel_last else x
    shape = (1, a.shape[1]) + (1,) * (a.dim() - 2)
    if not use_input_stats and running_mean is not None:
        mean, var = running_mean.reshape(shape), running_var.reshape(shape)
    else:
        dims = tuple(range(2, a.dim()))
        mean = a.mean(dims, keepdim=True)
        var = a.var(dims, unbiased=False, keepdim=True)
    out = _affine((a - mean) / torch.sqrt(var + eps), weight, bias, shape)
    return out.movedim(1, -1) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s)^beta``, ``s`` the sum of squares over
    ``size`` channels centred at each (the reference's form: ``alpha``
    not divided by ``size``, as torch's op divides it), zeros past the
    edges."""
    (x,) = cast_inputs("local_response_norm", x)
    ax = x.dim() - 1 if not data_format.startswith("NC") else 1
    lo = (size - 1) // 2
    pads = [0, 0] * (x.dim() - 1 - ax) + [lo, size - 1 - lo]
    sq = torch.nn.functional.pad(x * x, pads)
    c = x.shape[ax]
    window = sum(sq.narrow(ax, i, c) for i in range(size))
    return x / (k + alpha * window) ** beta
