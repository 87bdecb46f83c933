"""``CrossEntropyLoss`` (counterpart of ``paddle_tpu/nn/layer/loss.py``)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """``F.cross_entropy(input, label)`` with ``ignore_index`` and
    ``reduction``. The port's ``F.cross_entropy`` takes no class
    ``weight``, ``soft_label``, ``label_smoothing``, ``axis`` other than
    -1 or ``use_softmax=False``; given one, this layer raises
    ``NotImplementedError`` naming it."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        given = {"weight": weight is not None, "soft_label": soft_label,
                 "axis": axis != -1, "use_softmax": not use_softmax,
                 "label_smoothing": label_smoothing != 0.0}
        for arg, on in given.items():
            if on:
                raise NotImplementedError(
                    f"CrossEntropyLoss({arg}=...) is not ported: "
                    f"F.cross_entropy takes only ignore_index and reduction")
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, ignore_index=self._ignore_index,
                               reduction=self._reduction)
