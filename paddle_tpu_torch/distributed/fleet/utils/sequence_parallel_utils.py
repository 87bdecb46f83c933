"""Megatron-style sequence parallelism (SP).

Counterpart of ``paddle_tpu/distributed/fleet/utils/
sequence_parallel_utils.py``. SP shards the sequence dim of the
activations between the tensor-parallel linears (norms, residuals) over
``mp``. The reference states each op as a sharding constraint on its
``[b, s, h]`` layout (dim 1) and GSPMD emits the collectives; here each
op is an autograd Function over the ``mp`` group of the hybrid group:

- :class:`ScatterOp`: this rank's sequence chunk; backward all-gather;
- :class:`GatherOp`: all-gather the sequence; backward this rank's
  chunk;
- :class:`AllGatherOp`: all-gather before a column-parallel product;
  backward reduce-scatter (the product's input gradient is partial);
- :class:`ReduceScatterOp`: reduce-scatter after a row-parallel
  product; backward all-gather.

A parameter applied to sequence shards (an RMSNorm's weight, a
row-parallel bias under SP) gets only its shard's part of the gradient.
The reference needs no hook for that (GSPMD sums it), and so
:func:`register_sequence_parallel_allreduce_hooks` stays a no-op here
too: the layers that use such a parameter sum its gradient over ``mp``
in their backward (:class:`RowSequenceParallelLinear`'s bias, the Llama's
norms), so a script that registers the hooks gets nothing summed twice.
"""
from __future__ import annotations

from ... import _comm
from ..meta_parallel.parallel_layers.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, _axis_group,
)

__all__ = ["ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
           "scatter", "all_gather", "reduce_scatter",
           "mark_as_sequence_parallel_parameter",
           "is_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]

SEQ_DIM = 1  # the reference's [b, s, h]


def _mp():
    return _axis_group("mp")[2]


class ScatterOp:
    @staticmethod
    def apply(x, group=None):
        return _comm.scatter_to(x, SEQ_DIM, group or _mp())


class GatherOp:
    @staticmethod
    def apply(x, group=None):
        return _comm.gather_from(x, SEQ_DIM, group or _mp())


class AllGatherOp:
    @staticmethod
    def apply(x, group=None):
        return _comm.gather_reduce(x, SEQ_DIM, group or _mp())


class ReduceScatterOp:
    @staticmethod
    def apply(x, group=None):
        return _comm.reduce_scatter(x, SEQ_DIM, group or _mp())


def scatter(x):
    return ScatterOp.apply(x)


def all_gather(x):
    return AllGatherOp.apply(x)


def reduce_scatter(x):
    return ReduceScatterOp.apply(x)


def mark_as_sequence_parallel_parameter(parameter):
    """Tag a parameter that is applied to sequence shards."""
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter):
    return getattr(parameter, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """A no-op, as in the reference (see the module note)."""
    return None


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """A column-parallel linear whose input arrives sequence-sharded: the
    sequence is all-gathered (backward reduce-scatter) before the
    product, and the output is sharded on its features."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=False, fuse_matmul_bias=False,
                 mp_group=None, name=None, **kw):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias, gather_output=gather_output,
                         fuse_matmul_bias=fuse_matmul_bias,
                         mp_group=mp_group, name=name, **kw)

    def _enter(self, x):
        return _comm.gather_reduce(x, SEQ_DIM, self._group)


class RowSequenceParallelLinear(RowParallelLinear):
    """A row-parallel linear whose output leaves sequence-sharded: the
    partial products are reduce-scattered over the sequence (backward
    all-gather); its bias, added to sequence shards, has its gradient
    summed over ``mp``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True,
                 fuse_matmul_bias=False, mp_group=None, name=None, **kw):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         has_bias=has_bias,
                         input_is_parallel=input_is_parallel,
                         fuse_matmul_bias=fuse_matmul_bias,
                         mp_group=mp_group, name=name, **kw)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def _exit(self, out):
        return _comm.reduce_scatter(out, SEQ_DIM, self._group)

    def _bias(self):
        return _comm.copy_to(self.bias, self._group)
