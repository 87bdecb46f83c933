"""Process-wide cache of captured CUDA graphs: the in-memory tier of
``paddle_tpu/jit/exec_cache.py``.

The reference routes every compile through ``get_or_compile``: a phase
program is traced, lowered and compiled once per key, and each later
call is one executable launch. The port's counterpart of an executable
is a CUDA graph. :func:`get_or_capture` runs a function once eagerly on
a side stream (the warm-up the ``torch.cuda.graph`` protocol asks for:
it builds cuBLAS handles and workspaces outside the capture), then
captures one call into a ``torch.cuda.CUDAGraph`` on that stream; a
replay runs every kernel of the call with no Python in between.

A graph reads and writes fixed addresses. So its entry keeps the static
input tensors it was captured on (the caller copies each call's inputs
into them before :meth:`GraphEntry.replay`) and the outputs it writes,
and a caller's key names, besides shapes and dtypes, every buffer the
graph binds (weights, pools): a hit hands back a program bound to those
very tensors. Keys are the caller's nested structure, frozen; the entry
stores the key's full repr and a hit compares it, so a hash collision
cannot alias two programs. The map is bounded like the reference's mem
tier (``PT_EXEC_CACHE_MEM_LIMIT``, 64 entries, least recently used out
first); eviction drops the cache's reference, never a caller's.

All graphs share one graph memory pool (a fresh one after a capture
that failed, and once every graph captured into it has been freed: the
allocator refuses to begin a capture into a pool none of whose graphs
lives while tensors allocated in it do, as a model's gradients outlive
a collected ``TrainStep``). A graph's intermediates may then lie where
another graph's outputs lie, so a caller reads (or copies) a graph's
outputs before it replays another graph.

Kernel-wrapper counters (``paged_attend.launches`` and the like) count
in Python, so a capture would count calls that launched nothing and a
replay none of those it launches. ``get_or_capture`` takes the wrappers
to watch: it records how many calls the capture made to each, sets the
counters back to where they stood before the warm-up (the warm-up and
the capture run on placeholder inputs, for no caller), and each replay
adds the captured calls again.

Not ported: the disk tier (serialized executables; a CUDA graph has no
serialized form), the monitor hooks and the program audit.
"""
from __future__ import annotations

import collections
import hashlib
import os
import re
import time
import weakref

import torch

__all__ = ["GraphEntry", "get_or_capture", "array_spec", "key_hash",
           "clear", "stats", "drop", "side_stream"]

# least recently used out past this many entries
_MAX_MEM_ENTRIES = int(os.environ.get("PT_EXEC_CACHE_MEM_LIMIT", "64")
                       or 64)

_mem: "collections.OrderedDict[str, GraphEntry]" = collections.OrderedDict()
_stats = {"captures": 0, "hits": 0, "capture_ms": 0.0}
_streams: dict = {}  # device -> the side stream every capture runs on
_pool = None  # the graph memory pool every capture shares
_pool_graphs: dict = {}  # pool -> how many graphs captured into it live


def clear() -> None:
    """Drop every entry and zero the stats (test isolation)."""
    _mem.clear()
    for k in _stats:
        _stats[k] = 0.0 if k == "capture_ms" else 0


def drop(key) -> None:
    """Forget ``key``'s entry, if the cache holds it (an owner that dies
    releases its graphs)."""
    rep, sha = key_hash(key)
    entry = _mem.get(sha)
    if entry is not None and entry.key_repr == rep:
        del _mem[sha]


def stats() -> dict:
    """``captures``, ``hits``, ``capture_ms`` (wall time of every capture,
    warm-up included) and ``mem_entries``."""
    return {**_stats, "mem_entries": len(_mem)}


def _freeze(obj):
    """Canonical hashable form of a caller key: dicts sort, sequences
    become tuples, scalars pass through, anything else reprs."""
    if isinstance(obj, dict):
        return tuple((str(k), _freeze(v)) for k, v in
                     sorted(obj.items(), key=lambda kv: str(kv[0])))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    if isinstance(obj, (int, float, bool, str, bytes, type(None))):
        return obj
    return re.sub(r" at 0x[0-9a-f]+", "", repr(obj))


def array_spec(t: torch.Tensor) -> tuple:
    """(shape, dtype, device) of a tensor."""
    return (tuple(int(d) for d in t.shape), str(t.dtype), str(t.device))


def key_hash(key) -> tuple[str, str]:
    """(full key repr, sha256 hex) of a caller key."""
    rep = repr(_freeze(key))
    return rep, hashlib.sha256(rep.encode()).hexdigest()


class GraphEntry:
    """One captured program: the graph, the static ``inputs`` it reads
    (a dict, as passed to :func:`get_or_capture`), the ``output`` its
    capture returned, and ``calls``, the captured calls of each watched
    kernel wrapper."""

    __slots__ = ("graph", "inputs", "output", "calls", "key_repr",
                 "capture_ms")

    def __init__(self, graph, inputs, output, calls, key_repr, capture_ms):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.calls = calls
        self.key_repr = key_repr
        self.capture_ms = capture_ms

    def replay(self):
        """Run the captured call on the current stream (after the caller
        has written this call's values into ``inputs``); returns
        ``output``, overwritten in place."""
        self.graph.replay()
        for wrapper, n in self.calls.items():
            wrapper.launches += n
        return self.output


def side_stream(device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` runs on (a caller that
    makes its own warm-up call runs it there)."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _graph_pool():
    global _pool
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    return _pool


def _track(graph, pool) -> None:
    """Count ``graph`` among ``pool``'s live graphs until it is freed;
    when the last of the shared pool's graphs goes, the next capture
    takes a fresh pool."""
    _pool_graphs[pool] = _pool_graphs.get(pool, 0) + 1
    weakref.finalize(graph, _untrack, pool)


def _untrack(pool) -> None:
    global _pool
    _pool_graphs[pool] -= 1
    if not _pool_graphs[pool]:
        del _pool_graphs[pool]
        if pool == _pool:
            _pool = None


def _abandon_capture(device, stream):
    """Clean up after a capture that failed inside ``torch.cuda.graph``:
    its ``capture_end`` raised before the caching allocator stopped
    routing to the graph pool and before the capture stream stopped being
    the current one. End the routing, make ``stream`` current again, and
    start a fresh pool for later captures (the allocator refuses to begin
    another capture into the old one)."""
    global _pool
    try:
        torch._C._cuda_endAllocateToPool(device.index, _pool)
    except RuntimeError:
        pass  # capture_end got as far as ending it
    torch.cuda.set_stream(stream)
    _pool = None


def _capture(fn, inputs, label, counters, warmup=True):
    device = next(t.device for t in inputs.values()
                  if isinstance(t, torch.Tensor))
    stream = side_stream(device)
    start = {w: w.launches for w in counters}
    if warmup:
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(**inputs)
        torch.cuda.current_stream(device).wait_stream(stream)
    before = {w: w.launches for w in counters}
    graph = torch.cuda.CUDAGraph()
    caller = torch.cuda.current_stream(device)
    pool = _graph_pool()
    try:
        # the context synchronizes the device before the capture begins
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            output = fn(**inputs)
        _track(graph, pool)
    except RuntimeError as e:
        _abandon_capture(device, caller)
        raise RuntimeError(f"{label}: the phase could not be captured as "
                           f"a CUDA graph ({str(e).splitlines()[0]})") from e
    finally:
        calls = {w: w.launches - before[w] for w in counters}
        for w in counters:
            w.launches = start[w]
    torch.cuda.synchronize(device)
    return graph, output, calls


def get_or_capture(key, fn, static_inputs: dict, label: str,
                   counters=(), warmup=True) -> GraphEntry:
    """The entry for ``key``: from the cache, or captured now as
    ``fn(**static_inputs)`` (CUDA tensors; ``fn`` returns its outputs).
    On a hit ``static_inputs`` is ignored: the entry's own ``inputs`` are
    the tensors its graph reads. ``counters`` are the kernel wrappers
    whose ``launches`` the replays must keep right. A capture that fails
    raises ``RuntimeError`` naming ``label``; there is no eager
    fallback. ``warmup=False`` skips the eager warm-up call, for a caller
    that has just made one itself on :func:`side_stream` (a train step,
    whose warm-up is its first real step)."""
    rep, sha = key_hash(key)
    entry = _mem.get(sha)
    if entry is not None and entry.key_repr == rep:
        _mem.move_to_end(sha)
        _stats["hits"] += 1
        return entry
    t0 = time.perf_counter()
    args = (fn, static_inputs, label, counters)
    graph, output, calls = (_capture(*args) if warmup
                            else _capture(*args, warmup=False))
    ms = (time.perf_counter() - t0) * 1e3
    entry = GraphEntry(graph, static_inputs, output, calls, rep, ms)
    _stats["captures"] += 1
    _stats["capture_ms"] += ms
    _mem[sha] = entry
    _mem.move_to_end(sha)
    while len(_mem) > _MAX_MEM_ENTRIES:
        _mem.popitem(last=False)
    return entry
