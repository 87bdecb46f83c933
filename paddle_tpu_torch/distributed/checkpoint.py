"""Distributed checkpoint: per-region save and reshard-on-load.

Counterpart of ``paddle_tpu/distributed/checkpoint.py``, in its format
2, so a checkpoint written by either package loads in the other:

  index.json                       {"format": 2, "tensors": {key: meta}}
  <key>.r<start>x<start>....npy    one .npy per unique region

``meta`` is ``{"shape", "dtype", "spec", "shards": [{"file", "index":
[[start, stop], ...], "bytes"}]}``. There a tensor is a global array and
its regions come from its sharding; here each rank holds its piece of
the global tensor, and the regions come from the tensor's layout
(``_dist_layout``, a ``shard.Layout``, as a tensor-parallel, expert or
ZeRO ``p_g_os`` parameter records it, both cuts under mp x ZeRO;
:func:`optimizer_state` gives an optimizer's states and masters with
theirs): one region per segment of each cut dim, so a fused weight's
rank writes one region per segment. A tensor without a layout is whole
on every rank that holds it, as is a number. The ranks exchange the
regions they hold (one ``all_gather_object``); each region is written
by the lowest rank that holds it, and the coordinator writes the index
after a barrier, its presence the mark of a complete checkpoint
(written atomically).

Load reads, for each destination tensor, only this rank's regions (its
layout's), each from the overlapping byte ranges of the region files
(mmap), and copies them into the tensor in place: any layout loads from
any other (2 ranks to 1 and back, ZeRO on or off, mp 1 or 2).

bfloat16 is written as its uint16 view with ``"dtype": "bfloat16"`` in
the index and read back as ``torch.bfloat16``; the reference's
bfloat16 files (raw 2-byte records) read the same way, so no
``ml_dtypes`` is needed.

Async save takes a host snapshot of every region before the call
returns (a source changed afterwards does not change the file), through
a queue bounded in bytes (``max_inflight_bytes``) to one writer thread;
joining the thread (or :func:`wait_all`) raises if the writer failed and
then runs the barriers and the index write on the caller's thread.
"""
from __future__ import annotations

import collections
import json
import os
import re
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..framework.io import to_tensor
from . import shard

__all__ = ["save_state_dict", "load_state_dict", "load_checkpoint",
           "wait_all", "is_complete", "atomic_write_json",
           "optimizer_state"]

_INDEX = "index.json"
_CHUNK_BYTES = 64 << 20  # streaming-chunk size for large regions


def _safe_name(key):
    return re.sub(r"[^0-9A-Za-z_.\-]", "_", key)


def atomic_write_json(path, obj):
    """Crash-safe JSON publish: tmp, fsync, rename, then the parent
    directory's fsync; a crash mid-write leaves only the ``.tmp``."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # platform without directory fsync
        pass


def _region_tag(bounds):
    if not bounds:
        return "r0"
    return "r" + "x".join(str(b[0]) for b in bounds)


_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.bool: "bool"}


def _dtype_name(t):
    if isinstance(t, torch.Tensor):
        return _DTYPE_NAMES.get(t.dtype) or str(t.dtype).split(".")[1]
    return str(np.asarray(t).dtype)


def _np_dtype(name):
    """The numpy dtype a region is stored and read in (bfloat16: its
    uint16 view)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _host(t):
    """A tensor's (or a number's) value as an owned numpy array;
    bfloat16 as its uint16 view."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    owned = t.is_cuda  # the copy to the host is the snapshot
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.contiguous().view(torch.int16)
        a = t.numpy().view(np.uint16)
    else:
        a = t.numpy()
    return a if owned else a.copy()


def _pieces(t):
    """This rank's regions of ``t`` as ``{tag: (bounds, local tensor or
    value)}`` and its global shape: one region per segment of each cut
    dim of its layout (``shard.regions``), or the whole tensor."""
    layout = getattr(t, "_dist_layout", None) \
        if isinstance(t, torch.Tensor) else None
    if layout is None:
        shape = list(t.shape) if isinstance(t, torch.Tensor) \
            else list(np.shape(t))
        bounds = [[0, d] for d in shape]
        return {_region_tag(bounds): (bounds, t)}, shape
    return {_region_tag(b): (b, part)
            for b, part, _ in shard.regions(t, layout)}, list(layout.shape)


def _spec(t):
    layout = getattr(t, "_dist_layout", None) \
        if isinstance(t, torch.Tensor) else None
    return None if layout is None else list(shard.layout_spec(layout))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier():
    if _world()[1] > 1:
        dist.barrier()


class _ByteQueue:
    """A producer/consumer queue bounded in bytes; a writer failure
    unblocks the producer and raises in it."""

    def __init__(self, max_bytes):
        self.max = max_bytes
        self._q = collections.deque()
        self._bytes = 0
        self._cv = threading.Condition()
        self._closed = False
        self.error = None

    def put(self, item, nbytes):
        with self._cv:
            while (self.error is None and self._bytes
                   and self._bytes + nbytes > self.max):
                self._cv.wait()
            if self.error is not None:
                raise RuntimeError(
                    "async checkpoint writer failed") from self.error
            self._q.append((item, nbytes))
            self._bytes += nbytes
            self._cv.notify_all()

    def get(self):
        with self._cv:
            while not self._q and not self._closed:
                self._cv.wait()
            if not self._q:
                return None
            item, nbytes = self._q.popleft()
            self._bytes -= nbytes
            self._cv.notify_all()
            return item

    def fail(self, exc):
        with self._cv:
            self.error = exc
            self._q.clear()
            self._bytes = 0
            self._cv.notify_all()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class _WriterThread(threading.Thread):
    """The async writer: ``join()`` re-raises its failure in the joining
    thread, then runs ``finalize`` (the barriers and the index write)
    there, once."""

    def __init__(self, target, finalize=None):
        super().__init__(daemon=True)
        self._target_fn = target
        self._finalize = finalize
        self._finalized = False
        self._lock = threading.Lock()
        self.error = None

    def run(self):
        try:
            self._target_fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in join()
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.is_alive():  # timeout expired
            return
        if self.error is not None:
            raise RuntimeError(
                "async checkpoint writer failed") from self.error
        with self._lock:
            if self._finalized or self._finalize is None:
                return
            self._finalized = True
        self._finalize()


def _seal_memmaps(path, open_memmaps):
    """Flush chunk-streamed region files and rename them from ``.tmp``:
    the rename marks a streamed file complete."""
    for fname, mm in open_memmaps.items():
        mm.flush()
        os.replace(os.path.join(path, fname + ".tmp"),
                   os.path.join(path, fname))
    open_memmaps.clear()


def _write_item(path, item, open_memmaps):
    kind = item[0]
    if kind == "npy":
        _, fname, arr = item
        np.save(os.path.join(path, fname), arr)
    elif kind == "chunk":
        _, fname, shape, dtype, row0, arr = item
        mm = open_memmaps.get(fname)
        if mm is None:
            mm = np.lib.format.open_memmap(
                os.path.join(path, fname + ".tmp"), mode="w+",
                dtype=dtype, shape=tuple(shape))
            open_memmaps[fname] = mm
        mm[row0:row0 + arr.shape[0]] = arr


def _plan(state_dict):
    """Every rank's regions, exchanged: (the index's entries, this rank's
    ``[(file name, bounds, data)]`` to write)."""
    rank, world = _world()
    mine, local = {}, {}
    for key, val in state_dict.items():
        regions, shape = _pieces(val)
        mine[key] = {"shape": shape, "dtype": _dtype_name(val),
                     "spec": _spec(val),
                     "regions": {tag: b for tag, (b, _) in regions.items()}}
        local[key] = regions
    every = [mine]
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, mine)
    entries, owner = {}, {}
    for r, held in enumerate(every):
        for key, m in held.items():
            e = entries.setdefault(key, {"shape": m["shape"],
                                         "dtype": m["dtype"],
                                         "spec": m["spec"], "regions": {}})
            for tag, bounds in m["regions"].items():
                e["regions"].setdefault(tag, bounds)
                owner.setdefault((key, tag), r)
    index = {}
    for key, e in entries.items():
        itemsize = _np_dtype(e["dtype"]).itemsize
        fbase = _safe_name(key)
        index[key] = {
            "shape": e["shape"], "dtype": e["dtype"], "spec": e["spec"],
            "shards": [{"file": f"{fbase}.{tag}.npy", "index": bounds,
                        "bytes": int(np.prod([b[1] - b[0] for b in bounds],
                                             dtype=np.int64)) * itemsize
                        if bounds else itemsize}
                       for tag, bounds in sorted(e["regions"].items())]}
    writes = [(f"{_safe_name(key)}.{tag}.npy", bounds, data)
              for key, regions in local.items()
              for tag, (bounds, data) in sorted(regions.items())
              if owner[(key, tag)] == rank]
    return index, writes


def _emit(fname, bounds, data, sink):
    """Stream one region into ``sink`` as owned host copies: whole, or
    in row chunks of at most ``_CHUNK_BYTES`` for a large one."""
    shape = tuple(b[1] - b[0] for b in bounds)
    if isinstance(data, torch.Tensor):
        nbytes = data.numel() * data.element_size()
    else:
        nbytes = np.asarray(data).nbytes
    if not shape or nbytes <= _CHUNK_BYTES:
        arr = _host(data)
        sink(("npy", fname, arr), max(arr.nbytes, 1))
        return
    rows = max(1, _CHUNK_BYTES // max(1, nbytes // shape[0]))
    for r0 in range(0, shape[0], rows):
        piece = _host(data[r0:r0 + rows])
        sink(("chunk", fname, shape, piece.dtype, r0, piece), piece.nbytes)


def save_state_dict(state_dict, path, process_group=None, coordinator_rank=0,
                    async_save=False, max_inflight_bytes=1 << 30):
    """Save ``{key: tensor or number}`` as a sharded checkpoint under
    ``path`` (collective: every rank calls it with its own pieces).
    Returns None, or with ``async_save`` the started writer thread:
    join it (or call :func:`wait_all`) before reading the files; the
    join raises if the writer failed. ``process_group`` is accepted and
    not read: the regions come from the tensors' layouts."""
    os.makedirs(path, exist_ok=True)
    index, writes = _plan(state_dict)
    is_coordinator = _world()[0] == coordinator_rank
    meta = {"format": 2, "tensors": index}

    def finalize():
        _barrier()  # every rank's regions on disk before the index
        if is_coordinator:
            atomic_write_json(os.path.join(path, _INDEX), meta)
        _barrier()  # no rank returns before the index exists

    if not async_save:
        open_memmaps = {}
        for fname, bounds, data in writes:
            _emit(fname, bounds, data,
                  lambda item, n: _write_item(path, item, open_memmaps))
        _seal_memmaps(path, open_memmaps)
        finalize()
        return None

    q = _ByteQueue(max_inflight_bytes)

    def writer():
        open_memmaps = {}
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                _write_item(path, item, open_memmaps)
            _seal_memmaps(path, open_memmaps)
        except BaseException as e:
            q.fail(e)
            raise

    t = _WriterThread(writer, finalize)
    t.start()
    try:
        for fname, bounds, data in writes:
            _emit(fname, bounds, data, q.put)
    finally:
        q.close()
    _pending.append(t)
    return t


_pending: list = []


def wait_all():
    """Block until every async save has finished; raises if a writer
    failed (its checkpoint is then incomplete)."""
    while _pending:
        _pending.pop().join()


def _np_from_file(fpath, dtype):
    """mmap a region file in its stored dtype (bfloat16: as uint16,
    from the port's uint16 files and the reference's raw 2-byte
    ones)."""
    data = np.load(fpath, mmap_mode="r")
    want = _np_dtype(dtype)
    if data.dtype != want and data.dtype.itemsize == want.itemsize:
        data = data.view(want)
    return data


def _read_region(path, meta, bounds):
    """One region ``[[start, stop], ...]`` of a tensor from the region
    files that overlap it, reading only the overlaps (mmap); numpy in
    the stored dtype."""
    shape = tuple(b[1] - b[0] for b in bounds)
    out = np.empty(shape, _np_dtype(meta["dtype"]))
    for sh in meta["shards"]:
        s_bounds = sh["index"]
        lo = [max(b[0], s[0]) for b, s in zip(bounds, s_bounds)]
        hi = [min(b[1], s[1]) for b, s in zip(bounds, s_bounds)]
        if any(lw >= h for lw, h in zip(lo, hi)):
            continue
        src = tuple(slice(lw - s[0], h - s[0])
                    for lw, h, s in zip(lo, hi, s_bounds))
        dst = tuple(slice(lw - b[0], h - b[0])
                    for lw, h, b in zip(lo, hi, bounds))
        data = _np_from_file(os.path.join(path, sh["file"]), meta["dtype"])
        out[dst] = data[src]
    return out


def _as_tensor(arr, dtype_name):
    """A region read in its stored dtype as a CPU tensor (bfloat16 from
    its uint16 view)."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return to_tensor(arr)


def _meta_v1_to_v2(meta):
    """v1 entries (``{"file": ...}``) read as one whole-tensor region."""
    if "shards" in meta:
        return meta
    meta = dict(meta)
    meta["shards"] = [{"file": meta.pop("file"),
                       "index": [[0, d] for d in meta["shape"]]}]
    return meta


def _load_index(path):
    with open(os.path.join(path, _INDEX)) as f:
        raw = json.load(f)
    return {k: _meta_v1_to_v2(m) for k, m in raw["tensors"].items()}


def is_complete(path):
    """True iff ``path`` holds a complete, untorn checkpoint: the index
    parses, and every region file it names maps with its whole payload
    and the payload size the index recorded (a file torn by a crash
    mid-save fails)."""
    try:
        index = _load_index(path)
    except (OSError, ValueError, KeyError):
        return False
    for meta in index.values():
        for sh in meta.get("shards", []):
            try:
                data = np.load(os.path.join(path, sh["file"]),
                               mmap_mode="r")
            except Exception:  # noqa: BLE001 — torn/missing/corrupt
                return False
            want = sh.get("bytes")
            if want is not None and data.nbytes != want:
                return False
    return True


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, offload=False):
    """Load a checkpoint into ``{key: tensor}``: each tensor gets its own
    layout's regions (reshard-on-load), copied in place in its dtype and
    on its device; a number's entry is replaced by the value saved.
    Missing keys raise ``KeyError``, a global shape that differs
    ``ValueError``; extra checkpoint keys are ignored."""
    index = _load_index(path)
    for key, dest in state_dict.items():
        if key not in index:
            raise KeyError(f"checkpoint at {path} has no tensor {key!r}")
        meta = index[key]
        if not isinstance(dest, torch.Tensor):
            full = _read_region(path, meta, [[0, d] for d in meta["shape"]])
            state_dict[key] = full.item() if full.ndim == 0 else full
            continue
        regions, shape = _pieces(dest)
        if tuple(meta["shape"]) != tuple(shape):
            raise ValueError(
                f"{key}: checkpoint shape {tuple(meta['shape'])} != dest "
                f"{tuple(shape)} (shape-changing conversion is not a "
                "reshard)")
        with torch.no_grad():
            for bounds, part in regions.values():
                got = _as_tensor(_read_region(path, meta, bounds),
                                 meta["dtype"])
                part.copy_(got.reshape(part.shape))
    return state_dict


def load_checkpoint(path):
    """The whole checkpoint on the host: ``{key: CPU tensor}``."""
    index = _load_index(path)
    return {k: _as_tensor(_read_region(path, m, [[0, d]
                                                 for d in m["shape"]]),
                          m["dtype"])
            for k, m in index.items()}


def optimizer_state(optimizer):
    """``optimizer``'s state as :func:`save_state_dict` and
    :func:`load_state_dict` take it, under ``Optimizer.state_dict``'s
    keys: each parameter's states and master as this rank's tensors
    (the optimizer's own storage, so a load writes them in place) with
    the layout of their slice (``shard.grad_layout``), made where the
    optimizer has not made them yet; each step count and the global
    step as numbers. After a load, ``optimizer.set_state_dict`` takes
    the numbers (and copies the tensors)."""
    sd = {}
    for i, p in enumerate(optimizer._parameter_list):
        if not p.requires_grad:
            continue
        name = optimizer._name(p) or f"param_{i}"
        optimizer._work(p, p.detach())  # makes them, as a first step
        layout = shard.grad_layout(p)
        tensors = dict(optimizer._accumulators[id(p)])
        if id(p) in optimizer._master_weights:
            tensors["master_weight"] = optimizer._master_weights[id(p)]
        for k, v in tensors.items():
            alias = v.detach()
            if layout is not None:
                alias._dist_layout = layout
            sd[f"{name}.{k}"] = alias
        sd[f"{name}.step_count"] = optimizer._step_counts.get(id(p), 0)
    sd["global_step"] = optimizer._global_step
    return sd
