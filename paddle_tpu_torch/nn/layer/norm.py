"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
batch norm and its data-parallel ``SyncBatchNorm``, layer, RMS, group,
instance and local-response norm, and ``SpectralNorm``."""
from __future__ import annotations

import numpy as np
import torch

from ...distributed import _comm
from ...framework.device import current_device, resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


def _device(device):
    return current_device() if device is None else resolve_device(device)


def _scale_shift(layer, shape, weight_attr, bias_attr, device, generator):
    """A scale (ones) and a shift (zeros) of ``shape``, each None when its
    attr is False."""
    layer.weight = layer.create_parameter(
        shape, attr=weight_attr, default_initializer=I.Constant(1.0),
        device=device, generator=generator)
    layer.bias = layer.create_parameter(shape, attr=bias_attr, is_bias=True,
                                        device=device, generator=generator)


class _BatchNormBase(Layer):
    """A scale (ones) and a shift (zeros) unless their attr is False, and
    the fp32 running buffers ``_mean`` (zeros) and ``_variance`` (ones),
    named as the reference names them (``norm.py:36-37``), so the two
    packages' ``state_dict`` keys are the same. ``amp.decorate`` at O2
    casts the scale and shift and leaves the buffers fp32."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 generator=None):
        super().__init__()
        dev = _device(device)
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _scale_shift(self, [num_features], weight_attr, bias_attr, dev,
                     generator)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, "
                f"data_format={self._data_format}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class _SumOverGroup(torch.autograd.Function):
    """The group's sum of ``x`` on every member; its gradient is the
    group's sum of the members' gradients (each member's output depends
    on every member's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _comm.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _comm.all_reduce(g.contiguous().clone(), ctx.group), None


def _batch_group():
    """``(ranks, process group)`` of the ranks that hold other parts of
    the batch (the ``dp`` and ``sharding`` axes), or None at degree 1."""
    from ...distributed import env as env_mod

    env = env_mod.get_env()
    if env is None or env.degree("dp") * env.degree("sharding") <= 1:
        return None
    return env.group(("dp", "sharding"))


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics are the global batch's
    (``norm.py:67-92``): with one process per data-parallel rank, the
    batch's per-channel count, sum and sum of squares (fp32) are summed
    over the ``dp`` x ``sharding`` group, as GSPMD's sharded statistics
    are in the reference; the running buffers then move by Paddle's rule
    (momentum, unbiased variance of the global batch). At world size 1,
    in eval and with ``use_global_stats`` it is :class:`BatchNorm`."""

    def forward(self, x):
        group = _batch_group() if self.training \
            and not self._use_global_stats else None
        if group is None:
            return super().forward(x)
        channel_last = self._data_format in ("NLC", "NHWC", "NDHWC")
        a = x.movedim(-1, 1) if channel_last else x
        dims = [d for d in range(a.dim()) if d != 1]
        a32 = a.to(torch.float32)
        count = torch.full((1,), a.numel() / a.shape[1], device=a.device)
        stats = _SumOverGroup.apply(
            torch.cat([a32.sum(dims), (a32 * a32).sum(dims), count]), group)
        c = a.shape[1]
        n = stats[-1]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean * mean
        shape = [1] * a.dim()
        shape[1] = c
        out = (a32 - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self._epsilon)
        if self.weight is not None:
            out = out * self.weight.to(torch.float32).reshape(shape)
        if self.bias is not None:
            out = out + self.bias.to(torch.float32).reshape(shape)
        with torch.no_grad():
            m = self._momentum
            self._mean.mul_(m).add_((1 - m) * mean.detach())
            self._variance.mul_(m).add_(
                (1 - m) * var.detach() * n / torch.clamp(n - 1, min=1))
        out = out.to(x.dtype)
        return out.movedim(1, -1) if channel_last else out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch-norm sublayer (or itself) replaced by
        a ``SyncBatchNorm`` that shares its parameters and running
        buffers."""
        for name, sub in list(layer.named_children()):
            converted = cls.convert_sync_batchnorm(sub)
            if converted is not sub:
                setattr(layer, name, converted)
        if isinstance(layer, _BatchNormBase) \
                and not isinstance(layer, SyncBatchNorm):
            new = SyncBatchNorm(layer._num_features, layer._momentum,
                                layer._epsilon,
                                data_format=layer._data_format,
                                device=layer._mean.device)
            new.weight = layer.weight
            new.bias = layer.bias
            new.register_buffer("_mean", layer._mean)
            new.register_buffer("_variance", layer._variance)
            return new
        return layer


class LayerNorm(Layer):
    """``F.layer_norm`` over the trailing ``normalized_shape`` dims with a
    scale (ones) and a shift (zeros), each None when its attr is
    False."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, generator=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        _scale_shift(self, self._normalized_shape, weight_attr, bias_attr,
                     device, generator)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """``F.rms_norm`` over the last dim with a scale (ones)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None, *, device=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device,
            generator=generator)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    """``F.group_norm`` with a per-channel scale (ones) and shift
    (zeros)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        _scale_shift(self, [num_channels], weight_attr, bias_attr, device,
                     generator)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon, self._data_format)


class _InstanceNormBase(Layer):
    """``F.instance_norm`` with a per-channel scale (ones) and shift
    (zeros). As in the reference, ``momentum`` and ``data_format`` are
    accepted and the input is read channel-first."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, generator=None):
        super().__init__()
        self._epsilon = epsilon
        _scale_shift(self, [num_features], weight_attr, bias_attr, device,
                     generator)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (as ``[shape[dim], -1]``) estimated by ``power_iters`` steps of power
    iteration from the persistable buffers ``weight_u`` and ``weight_v``,
    which each call advances without gradient (``norm.py:204``). The
    buffers start as a normal draw from numpy's global generator, as the
    reference's do."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", *, device=None):
        super().__init__()
        dev = _device(device)
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.register_buffer("weight_u", torch.from_numpy(
            np.random.randn(h).astype(np.float32)).to(dev))
        self.register_buffer("weight_v", torch.from_numpy(
            np.random.randn(w).astype(np.float32)).to(dev))

    def forward(self, weight):
        mat = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                    -1)
        with torch.no_grad():
            u, v = self.weight_u, self.weight_v
            m = mat.detach()
            for _ in range(self._power_iters):
                v = m.T @ u
                v = v / (torch.linalg.vector_norm(v) + self._eps)
                u = m @ v
                u = u / (torch.linalg.vector_norm(u) + self._eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ mat @ v
        return weight / sigma
