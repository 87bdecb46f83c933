"""``TCPStore``: the key-value rendezvous store.

Counterpart of ``paddle_tpu/distributed/store.py``, which builds its
own server and client (``native/tcp_store.cpp``). The port wraps
``torch.distributed.TCPStore``, which ``torch.distributed`` already
ships, and keeps the reference's methods and errors.
"""
from __future__ import annotations

import datetime

import torch.distributed as dist

__all__ = ["TCPStore"]


class TCPStore:
    """``TCPStore(host, port, is_master, world_size, timeout)``; the
    master also runs the server (``port=0``: a free port, read back as
    ``.port``)."""

    def __init__(self, host="127.0.0.1", port=0, is_master=False,
                 world_size=1, timeout=900):
        self._timeout = float(timeout)
        self._store = dist.TCPStore(
            host, int(port), world_size if is_master else None,
            bool(is_master), datetime.timedelta(seconds=self._timeout),
            wait_for_workers=False)
        self.host = host
        self.port = self._store.port

    def set(self, key, value):
        data = value if isinstance(value, bytes) else str(value).encode()
        self._store.set(key, data)

    def get(self, key):
        """The value's bytes; ``KeyError`` if the key is not set."""
        if not self._store.check([key]):
            raise KeyError(key)
        return self._store.get(key)

    def add(self, key, amount=1):
        return int(self._store.add(key, int(amount)))

    def wait(self, keys, timeout=None):
        """Block until every key is set; ``TimeoutError`` after
        ``timeout`` seconds (the store's by default)."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        secs = self._timeout if timeout is None else float(timeout)
        try:
            self._store.wait(keys, datetime.timedelta(seconds=secs))
        except Exception as e:  # noqa: BLE001 — torch's DistStoreError
            if "timeout" in str(e).lower() or "timed out" in str(e).lower():
                raise TimeoutError(
                    f"TCPStore.wait timed out on {keys!r}") from e
            raise

    def delete_key(self, key):
        return bool(self._store.delete_key(key))
