"""``paddle.batch`` (counterpart of ``paddle_tpu/batch.py``): wrap a
sample-level reader (a function returning an iterator) into a batched
reader."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    """Create a batched reader from ``reader`` (a no-arg callable yielding
    samples). Yields lists of ``batch_size`` samples; the trailing partial
    batch is kept unless ``drop_last``."""
    if batch_size <= 0:
        raise ValueError(
            f"batch_size should be a positive integer, got {batch_size}")

    def batch_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
