"""The tensor op namespace (counterpart of ``paddle_tpu/tensor/``).

Every public op of the nine modules is re-exported here, the first
module to define a name winning in the reference's order (``cov`` and
``corrcoef`` are ``stat``'s; ``paddle_tpu_torch.linalg`` keeps
``linalg``'s own). The ops take and return ``torch.Tensor``s, take
Python numbers, lists and numpy arrays where the reference does, give
the reference's dtypes (32-bit-first: int32 indices and integer
reductions) and cast their inputs by ``amp.auto_cast`` under the
reference's op names. The reference's ``attach`` (its Tensor methods)
has no counterpart: ``torch.Tensor`` keeps torch's own methods.
"""
from . import (  # noqa: F401
    creation, linalg, logic, manipulation, math, random, search, stat,
)
from .creation import to_tensor  # noqa: F401
from .einsum import einsum  # noqa: F401

_MODULES = (math, manipulation, creation, logic, search, stat, linalg,
           random)


def _reexport(mod, into):
    for name in dir(mod):
        if name.startswith("_"):
            continue
        fn = getattr(mod, name)
        if callable(fn) and getattr(fn, "__module__", "").startswith(
                "paddle_tpu_torch.tensor"):
            into.setdefault(name, fn)


_ns: dict = {}
for _mod in _MODULES:
    _reexport(_mod, _ns)
globals().update(_ns)
