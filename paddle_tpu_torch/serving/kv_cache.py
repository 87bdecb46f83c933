"""Block (paged) KV-cache bookkeeping for the serving runtime.

Counterpart of ``paddle_tpu/serving/kv_cache.py``, copied near-verbatim:
it is host logic over numpy and hashlib, and the blake2b prefix keys are
byte-identical to the reference's.

The device side is two pool tensors ``[layers, num_blocks, block_size,
kv_heads, head_dim]`` owned by the engine; this module owns the HOST
side: which fixed-size blocks belong to which request, and the per-lane
block tables the engine's programs index through. Sequences of
different lengths share one decode program because length lives in the
*data* (block-table rows + per-lane valid lengths), never in the shapes
(the vLLM/PagedAttention memory model).

Block 0 is the NULL block: never allocated, it absorbs the engine's
masked writes (inactive decode lanes, prefill-chunk pad slots) so they
can never corrupt a live lane's KV. Allocation hands out blocks
1..num_blocks-1.

The pool is also a **prefix cache**: a block holding a full, frozen
chunk of context can be *published* under a chained content hash
(:func:`prefix_keys`) and later *acquired* by another request whose
context starts with the same tokens — the two lanes' block tables then
point at the SAME pool block, and the second request prefills nothing
for it. Sharing is ref-counted: ``free`` decrements instead of freeing,
and a block whose refcount hits zero while it is still indexed parks on
a **cold LRU** — its device K/V stays valid (nothing writes an unowned
block), so a future lookup revives it for free — and is reclaimed,
index entry evicted, only when the free list runs dry. Only full blocks
are ever published; the tail block of every lane stays private, so
decode writes never touch shared KV and no copy-on-write device copy is
ever needed.

Safety contract: every block tracks its holders, ``free`` validates
membership (a double-free or cross-request free raises instead of
silently aliasing two requests' KV), reclaim never touches a block with
refs > 0, and ``free + used + cold == capacity`` always holds,
disjointly.

The tail-block privacy rule is also what makes speculative decoding's
rollback free: the verify step writes draft K/V at positions past
``pool_len`` — always in the lane's private tail blocks — so rejecting
a draft is a ``pool_len`` rewind with no copy.

**int8 KV mode** (``ServingConfig(kv_int8=True)``): the engine's pools
store int8 K/V plus paired fp32 amax scale tensors ``[layers,
num_blocks, block_size, kv_heads]`` indexed by the SAME block ids this
ledger hands out. Nothing here changes: a block id means "these pool
slots AND their scale slots".
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np

__all__ = ["BlockPool", "blocks_needed", "prefix_keys"]


def blocks_needed(num_tokens: int, block_size: int) -> int:
    """Blocks covering positions ``0..num_tokens-1`` (0 tokens -> 0)."""
    return -(-int(num_tokens) // int(block_size))


def prefix_keys(tokens, block_size: int, limit_tokens: int | None = None):
    """Chained content keys for the FULL blocks of ``tokens``: key ``i``
    is ``blake2b(key_{i-1} || tokens[i*B:(i+1)*B])`` — so a key names
    the entire context up to and including its block, and two requests
    share block ``i`` iff their first ``(i+1)*B`` tokens are identical.
    ``limit_tokens`` caps the keyed span (admission passes ``ctx - 1``
    so at least one token is always left to prefill — the compiled
    final-chunk sampling needs a real position, and its K/V write must
    land in a private block). blake2b is deterministic across processes
    (unlike ``hash()``), keeping seeded-trace replays byte-identical."""
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    n = toks.size if limit_tokens is None else min(toks.size,
                                                  int(limit_tokens))
    keys = []
    prev = b""
    for i in range(int(n) // int(block_size)):
        chunk = toks[i * block_size:(i + 1) * block_size]
        prev = hashlib.blake2b(prev + chunk.tobytes(),
                               digest_size=16).digest()
        keys.append(prev)
    return keys


class BlockPool:
    """Free-list allocator + ref-counted prefix index over the pooled KV
    blocks (host bookkeeping).

    LIFO free list: a just-freed block is the next handed out, so under
    admission/eviction churn the working set stays compact (warm for
    any future locality-aware layout). The cold LRU is FIFO over
    release order: the longest-unreferenced cached prefix is reclaimed
    first.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # stack: pop() yields 1 first, then 2, ... — deterministic
        # allocation order is part of the replayable-scheduler contract
        self._free = list(range(self.num_blocks - 1, 0, -1))
        # block -> holder list; refcount == len (a holder appears once)
        self._holders: dict[int, list] = {}
        # prefix index: chained content key -> block id, and its inverse
        self._index: dict[bytes, int] = {}
        self._key_of: dict[int, bytes] = {}
        # unreferenced-but-indexed blocks, oldest release first
        self._cold: collections.OrderedDict = collections.OrderedDict()

    @property
    def capacity(self) -> int:
        """Allocatable blocks (the null block excluded)."""
        return self.num_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._holders)

    @property
    def cold_count(self) -> int:
        """Unreferenced-but-indexed blocks parked on the cold LRU."""
        return len(self._cold)

    @property
    def allocatable(self) -> int:
        """Blocks an :meth:`alloc` can hand out right now: the free
        list plus the reclaimable cold LRU — the pre-sharing meaning of
        "free" (cold blocks are spare capacity wearing a cache hat)."""
        return len(self._free) + len(self._cold)

    @property
    def indexed_count(self) -> int:
        """Blocks (live or cold) reachable through the prefix index."""
        return len(self._index)

    @property
    def shared_count(self) -> int:
        """Live blocks currently held by more than one request."""
        return sum(1 for h in self._holders.values() if len(h) > 1)

    def refcount(self, block: int) -> int:
        return len(self._holders.get(block, ()))

    def alloc(self, n: int, owner, reclaim_cold: bool = True) -> \
            list | None:
        """Allocate ``n`` PRIVATE blocks for ``owner``; None when the
        pool cannot satisfy the request (caller decides to wait or
        preempt — allocation itself never evicts a lane). The free list
        serves first; when it runs dry, cold blocks are reclaimed
        oldest-release-first, their index entries evicted. Blocks with
        refs > 0 are never touched. ``reclaim_cold=False`` draws from
        the free list ONLY — speculative draft growth must never evict
        a cached prefix to back a guess
        (``scheduler.grow_for_draft``)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > (self.allocatable if reclaim_cold else len(self._free)):
            return None
        blocks = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cold.popitem(last=False)  # oldest cold
                self._evict_index(b)
            blocks.append(b)
        for b in blocks:
            self._holders[b] = [owner]
        return blocks

    def free(self, blocks, owner) -> None:
        """Release ``owner``'s reference on each of ``blocks``. Raises on
        a double-free, on a block the pool never allocated, and on an
        owner that holds no reference — each is a lost-KV/aliased-KV bug
        upstream, never recoverable here. A block whose last reference
        drops returns to the free list, unless it is indexed — then it
        parks on the cold LRU with its device K/V intact, revivable by
        the next prefix hit."""
        for b in blocks:
            holders = self._holders.get(b)
            if holders is None:
                raise ValueError(
                    f"block {b} is not allocated (double-free, or never "
                    f"allocated) — freeing it would let two requests "
                    f"alias one KV block")
            if not any(h is owner for h in holders):
                raise ValueError(
                    f"block {b} is owned by {holders!r}, not {owner!r}")
        for b in blocks:
            holders = self._holders[b]
            for i, h in enumerate(holders):
                if h is owner:
                    del holders[i]
                    break
            if holders:
                continue  # other requests still reference the block
            del self._holders[b]
            if b in self._key_of:
                self._cold[b] = None  # newest-released = last reclaimed
            else:
                self._free.append(b)

    # -- prefix cache --------------------------------------------------------

    def lookup(self, keys) -> list:
        """Block ids for the longest indexed prefix of ``keys`` (chain
        keys from :func:`prefix_keys`). Read-only: refcounts and LRU
        order are untouched until :meth:`acquire`."""
        hits = []
        for key in keys:
            b = self._index.get(key)
            if b is None:
                break
            hits.append(b)
        return hits

    def acquire(self, blocks, owner) -> None:
        """Take a reference on each of ``blocks`` for ``owner`` — live
        shared blocks gain a holder, cold blocks revive off the LRU.
        Raises on a block that is no longer indexed or neither live nor
        cold (a STALE lookup result: an intervening alloc reclaimed and
        re-issued it, so acquiring now would alias another request's
        KV — :meth:`lookup` hits must be acquired before any
        reclaiming alloc) and on an owner that already holds the
        block."""
        for b in blocks:
            holders = self._holders.get(b)
            if holders is not None and any(h is owner for h in holders):
                raise ValueError(
                    f"block {b} is already held by {owner!r}")
            if b not in self._key_of or (holders is None
                                         and b not in self._cold):
                raise ValueError(
                    f"block {b} is not an indexed live/cold block — "
                    f"acquire must follow lookup before any reclaiming "
                    f"alloc")
        for b in blocks:
            if b in self._cold:
                del self._cold[b]
                self._holders[b] = [owner]
            else:
                self._holders[b].append(owner)

    def publish(self, key: bytes, block: int, owner) -> bool:
        """Index ``block`` — full and frozen, every slot written — under
        its chain ``key``. ``owner`` must hold the block (publishing KV
        you don't own is the aliasing bug class again). First publisher
        wins: a key already mapped to a DIFFERENT block is left alone
        (the newcomer's copy stays private) so an indexed block's
        content never changes under its readers. Returns whether the
        block is now (or already was) the key's indexed block."""
        holders = self._holders.get(block)
        if holders is None or not any(h is owner for h in holders):
            raise ValueError(
                f"publish: block {block} is not held by {owner!r}")
        have_key = self._key_of.get(block)
        if have_key is not None:
            if have_key != key:
                raise ValueError(
                    f"publish: block {block} is already indexed under a "
                    f"different key — content-keyed blocks are immutable")
            return True
        if key in self._index:
            return self._index[key] == block
        self._index[key] = block
        self._key_of[block] = key
        return True

    def _evict_index(self, block: int) -> None:
        key = self._key_of.pop(block, None)
        if key is not None and self._index.get(key) == block:
            del self._index[key]

    # -- introspection -------------------------------------------------------

    def owner_of(self, block: int):
        holders = self._holders.get(block)
        return holders[0] if holders else None

    def check_invariant(self) -> None:
        """free + used + cold == capacity, disjointly — the accounting
        identity the property tests drive through admission/preemption/
        sharing churn — plus the prefix-index consistency rules (every
        cold block indexed, every index entry live-or-cold, index and
        its inverse in bijection)."""
        if (len(self._free) + len(self._holders)
                + len(self._cold)) != self.capacity:
            raise AssertionError(
                f"block accounting broken: free {len(self._free)} + used "
                f"{len(self._holders)} + cold {len(self._cold)} != "
                f"capacity {self.capacity}")
        free, used, cold = (set(self._free), set(self._holders),
                            set(self._cold))
        for a, b, what in ((free, used, "free and owned"),
                           (free, cold, "free and cold"),
                           (used, cold, "owned and cold")):
            if a & b:
                raise AssertionError(f"blocks both {what}: {a & b}")
        if 0 in used or 0 in free or 0 in cold:
            raise AssertionError("null block 0 escaped reservation")
        if cold - set(self._key_of):
            raise AssertionError(
                f"cold blocks without an index entry: "
                f"{cold - set(self._key_of)}")
        for key, b in self._index.items():
            if self._key_of.get(b) != key:
                raise AssertionError(
                    f"index/inverse disagree on block {b}")
            if b not in used and b not in cold:
                raise AssertionError(
                    f"index names block {b} that is neither live nor cold")
        if set(self._key_of) - set(self._index.values()):
            raise AssertionError("inverse index carries unindexed blocks")
        for b, holders in self._holders.items():
            if not holders:
                raise AssertionError(f"block {b} held with zero holders")
