"""Structured errors: the ``PADDLE_ENFORCE_*`` analogue.

Counterpart of ``paddle_tpu/framework/errors.py``, of which it is a copy
(the port imports nothing of the JAX package). Each category
(InvalidArgument, NotFound, OutOfRange, AlreadyExists,
PermissionDenied, PreconditionNotMet, Unimplemented, Unavailable,
ExecutionTimeout) is an exception that subclasses the matching builtin,
so ``except ValueError`` callers keep working, and carries the raising
source location. ``enforce(cond, ...)`` mirrors ``PADDLE_ENFORCE``;
``enforce_eq/gt/...`` mirror the comparison macros and name both
operands.
"""
from __future__ import annotations

import inspect

__all__ = [
    "EnforceError", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "PermissionDeniedError",
    "PreconditionNotMetError", "UnimplementedError", "UnavailableError",
    "ExecutionTimeoutError", "enforce", "enforce_eq", "enforce_ne",
    "enforce_gt", "enforce_ge", "enforce_lt", "enforce_le",
    "enforce_not_none",
]


class EnforceError(Exception):
    """Base for enforce failures (reference `EnforceNotMet`,
    `phi/core/enforce.h`)."""

    category = "Error"

    def __init__(self, message, location=None):
        self.summary = message
        self.location = location
        text = f"{self.category}: {message}"
        if location:
            text += f"\n  [operator raised at {location}]"
        super().__init__(text)


class InvalidArgumentError(EnforceError, ValueError):
    category = "InvalidArgument"


class NotFoundError(EnforceError, LookupError):
    category = "NotFound"


class OutOfRangeError(EnforceError, IndexError):
    category = "OutOfRange"


class AlreadyExistsError(EnforceError):
    category = "AlreadyExists"


class PermissionDeniedError(EnforceError):
    category = "PermissionDenied"


class PreconditionNotMetError(EnforceError, RuntimeError):
    category = "PreconditionNotMet"


class UnimplementedError(EnforceError, NotImplementedError):
    category = "Unimplemented"


class UnavailableError(EnforceError, RuntimeError):
    category = "Unavailable"


class ExecutionTimeoutError(EnforceError, TimeoutError):
    category = "ExecutionTimeout"


def _caller(depth=2):
    frame = inspect.stack()[depth]
    return f"{frame.filename}:{frame.lineno}"


def enforce(cond, message, error=InvalidArgumentError):
    """PADDLE_ENFORCE: raise `error` with source location when ``cond``
    is falsy."""
    if not cond:
        raise error(message, _caller())


def _cmp(a, b, op, opname, message, error):
    if not op(a, b):
        detail = (f"{message} (expected lhs {opname} rhs, got "
                  f"lhs={a!r}, rhs={b!r})")
        raise error(detail, _caller(3))


def enforce_eq(a, b, message, error=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x == y, "==", message, error)


def enforce_ne(a, b, message, error=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x != y, "!=", message, error)


def enforce_gt(a, b, message, error=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x > y, ">", message, error)


def enforce_ge(a, b, message, error=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x >= y, ">=", message, error)


def enforce_lt(a, b, message, error=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x < y, "<", message, error)


def enforce_le(a, b, message, error=InvalidArgumentError):
    _cmp(a, b, lambda x, y: x <= y, "<=", message, error)


def enforce_not_none(value, message, error=NotFoundError):
    if value is None:
        raise error(message, _caller())
    return value
