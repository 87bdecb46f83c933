"""Continuous-batching scheduler: FCFS admission, finished-lane
reclamation, recompute-on-preemption.

Counterpart of ``paddle_tpu/serving/scheduler.py``, copied
near-verbatim: pure host logic over
:class:`~paddle_tpu_torch.serving.kv_cache.BlockPool`, so on the same
seeded trace its ``events`` are byte-identical to the reference's. The
reference's monitor slots (flight-recorder spans) are not ported yet.

Policy (the Orca/vLLM iteration-level discipline, recompute variant):

- **Admission** is FCFS from the waiting deque: the head request is
  admitted iff a lane is free AND the pool can cover its context plus
  the first decode write — with the prefix cache on, the longest
  block-aligned indexed prefix is acquired (shared, ref-counted)
  instead of allocated, and the engine prefills only from
  ``cached_len`` on. Admission never preempts — runners hold their
  blocks until they finish or growth forces eviction.
- **Growth**: each decode step may cross a block boundary;
  :meth:`ensure_capacity` allocates the next block, and when the pool is
  dry it preempts the MOST RECENTLY admitted runner (never an older one
  — the oldest request always progresses, which is the no-starvation
  argument). Speculative draft positions grow through
  :meth:`grow_for_draft` instead, which NEVER preempts: a dry pool
  trims the draft, and :meth:`release_draft_blocks` returns the unused
  tail after every verify round. A preempted request keeps its
  generated tokens, frees its blocks, and re-queues at the FRONT of the
  waiting deque in arrival order; on re-admission the engine re-prefills
  prompt+output (greedy decode is deterministic, so recompute continues
  exactly as long as prefill and decode round K/V identically).
- **Reclamation**: a finished lane frees its blocks and its lane slot
  the moment its last token is emitted; the next admit() fills it.

Every decision lands in ``self.events`` as ``(event, request_id,
detail)`` — the deterministic-replay audit trail (a bounded ring:
newest ``events_cap`` decisions, 65536 by default). The per-request
latency attribution (``Request.queue_ms``/...) is always on: one
``perf_counter`` read per admission and per preemption.
"""
from __future__ import annotations

import collections
import itertools
import time

import numpy as np

from .kv_cache import BlockPool, blocks_needed, prefix_keys

__all__ = ["Request", "FCFSScheduler",
           "WAITING", "RUNNING", "FINISHED"]

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"

_auto_id = itertools.count()


class Request:
    """One generation request and its full lifecycle state.

    ``output`` accumulates generated token ids (the LAST entry, while
    running, is the *pending* token — sampled but not yet written to the
    KV pool; the engine feeds it to the next decode step). ``blocks``
    is the lane's block table in position order. Timestamps
    (``t_submit``/``t_first``/``t_done``, engine clock seconds) carry
    the TTFT / per-token-latency facts.

    Attribution (always on, plain float/int arithmetic like the
    engine's counters): the engine telescopes every request's wall
    time into ``queue_ms`` (submit -> first admission), ``prefill_ms``,
    ``decode_ms`` (on-lane time between prefill end and finish, incl.
    host scheduling between rounds), and ``preempted_ms`` (preempt ->
    re-admission), advancing ``_t_mark`` at each phase boundary — the
    four buckets sum to ``t_done - t_submit`` exactly. ``trace_id`` is
    assigned at first admission (``r<request_id>``), as in the
    reference.
    """

    __slots__ = ("request_id", "prompt", "max_new_tokens", "eos_token_id",
                 "state", "output", "blocks", "lane", "pool_len",
                 "cached_len", "prefix_cached_tokens",
                 "ttft_cached_tokens", "_pkeys",
                 "t_submit", "t_first", "t_done", "preemptions",
                 "_admit_seq", "trace_id", "_t_mark",
                 "queue_ms", "prefill_ms", "decode_ms", "preempted_ms",
                 "prefill_refunded_tokens", "spec_rounds",
                 "accepted_tokens")

    def __init__(self, prompt_ids, max_new_tokens=32, eos_token_id=None,
                 request_id=None):
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.request_id = (request_id if request_id is not None
                           else next(_auto_id))
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.state = WAITING
        self.output: list = []
        self.blocks: list = []
        self.lane = None
        # tokens whose K/V sit in the pool (= prefilled context while
        # running; the pending output token is NOT yet written)
        self.pool_len = 0
        # leading tokens covered by acquired prefix-cache blocks at the
        # CURRENT admission (prefill starts here; reset on preemption)
        self.cached_len = 0
        # lifetime cache credit across (re-)admissions (stats), and the
        # FIRST admission's credit alone — the admission whose prefill
        # sets t_first, so a cached-vs-cold TTFT split groups by it (a
        # later recompute hit must not relabel a cold-TTFT request as
        # cached)
        self.prefix_cached_tokens = 0
        self.ttft_cached_tokens = None
        # chain-key cache for the current prefill context (ctx, keys):
        # a blocked admission retries every engine step, and rehashing
        # a long context per retry is pure repeated work. ctx alone
        # keys the cache — prefill_tokens only ever grows (recompute
        # appends kept output), so equal length implies equal content.
        self._pkeys = None
        self.t_submit = None
        self.t_first = None
        self.t_done = None
        self.preemptions = 0
        self._admit_seq = -1
        # per-request latency attribution (see class docstring): the
        # engine advances _t_mark at every phase boundary so the four
        # *_ms buckets telescope to exactly t_done - t_submit
        self.trace_id = None
        self._t_mark = None
        self.queue_ms = 0.0
        self.prefill_ms = 0.0
        self.decode_ms = 0.0
        self.preempted_ms = 0.0
        # recomputed-context tokens a re-admission's prefix-cache hit
        # refunded (served from shared blocks instead of re-prefilled)
        self.prefill_refunded_tokens = 0
        self.spec_rounds = 0
        self.accepted_tokens = 0

    def attribution(self) -> dict:
        """The finished request's latency breakdown. Phase buckets
        are ms on the engine clock; for a FINISHED request they sum to
        ``t_done - t_submit`` (within float rounding)."""
        return {
            "queue_ms": self.queue_ms,
            "prefill_ms": self.prefill_ms,
            "decode_ms": self.decode_ms,
            "preempted_ms": self.preempted_ms,
            "prefill_refunded_tokens": self.prefill_refunded_tokens,
            "spec_rounds": self.spec_rounds,
            "accepted_tokens": self.accepted_tokens,
        }

    @property
    def prefill_tokens(self) -> np.ndarray:
        """The context a (re-)prefill must write to the pool: the prompt
        plus all generated tokens EXCEPT the pending last one."""
        if not self.output:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.output[:-1], np.int32)])

    @property
    def finished(self) -> bool:
        return self.state == FINISHED


class FCFSScheduler:
    """Lane + block assignment between steps; see module docstring."""

    def __init__(self, pool: BlockPool, max_lanes: int,
                 blocks_per_lane: int, max_seq_len: int,
                 events_cap: int = 65536, prefix_cache: bool = True):
        if max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1, got {max_lanes}")
        self.pool = pool
        # prefix-cache policy switch (PT_SERVE_PREFIX_CACHE via
        # ServingConfig): off = the pre-sharing admission path, byte for
        # byte — no lookups, no publishes, cold LRU stays empty
        self.prefix_cache = bool(prefix_cache)
        self.max_lanes = int(max_lanes)
        self.blocks_per_lane = int(blocks_per_lane)
        self.max_seq_len = int(max_seq_len)
        self.waiting: collections.deque = collections.deque()
        self.lanes: list = [None] * self.max_lanes
        # audit trail as a bounded ring:
        # newest events_cap decisions kept, so a long-running server's
        # host memory does not grow with its request history
        self.events: collections.deque = collections.deque(
            maxlen=events_cap)
        self._admit_counter = itertools.count()

    # -- intake --------------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Queue a request; validates it can EVER run (total length within
        the lane's block table and the pool) so an impossible request
        fails loudly at the door, not as a livelock mid-serve."""
        total = int(req.prompt.size) + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {req.request_id}: prompt {req.prompt.size} + "
                f"max_new_tokens {req.max_new_tokens} = {total} exceeds "
                f"max_seq_len {self.max_seq_len}")
        need = blocks_needed(total, self.pool.block_size)
        if need > min(self.pool.capacity, self.blocks_per_lane):
            raise ValueError(
                f"request {req.request_id} needs {need} KV blocks but the "
                f"pool holds {self.pool.capacity} "
                f"({self.blocks_per_lane}/lane) — raise PT_SERVE_BLOCKS "
                f"or shrink the request")
        req.state = WAITING
        self.waiting.append(req)
        self.events.append(("submit", req.request_id, None))
        return req

    # -- admission -----------------------------------------------------------

    def free_lane(self):
        for i, r in enumerate(self.lanes):
            if r is None:
                return i
        return None

    def admit(self, limit: int | None = None) -> list:
        """FCFS: move waiting-head requests onto free lanes while blocks
        cover each one's context + first decode write. With the prefix
        cache on, the head request's longest block-aligned indexed
        prefix is acquired (ref-counted, possibly reviving cold blocks)
        and only the remainder is privately allocated — the engine's
        prefill then starts at ``cached_len``. Returns the newly
        admitted requests (engine prefills them before the next decode
        round). The engine passes ``limit=1`` and prefills+publishes
        between admissions, so a BURST of same-prompt arrivals shares
        from the second request on — admitting a whole wave first would
        privately allocate every lane's copy before any prefix was
        published."""
        admitted = []
        while self.waiting and (limit is None or len(admitted) < limit):
            lane = self.free_lane()
            if lane is None:
                break
            req = self.waiting[0]
            ctx = len(req.prefill_tokens)
            hits = []
            if self.prefix_cache:
                # cap at ctx-1: at least one token always prefills, so
                # the final-chunk sampling position and its K/V write
                # stay in a lane-private block (no shared-block writes)
                hits = self.pool.lookup(self._chain_keys(req)[
                    :(ctx - 1) // self.pool.block_size])
            # context to prefill + the first decode write right after it
            need = blocks_needed(ctx + 1, self.pool.block_size)
            # acquire the hits FIRST: a cold hit revived here can no
            # longer be reclaimed by the private alloc below
            self.pool.acquire(hits, req)
            blocks = self.pool.alloc(need - len(hits), req)
            if blocks is None:
                self.pool.free(hits, req)  # back to the cold LRU
                break  # runners will free blocks as they finish
            self.waiting.popleft()
            req.blocks = hits + blocks
            req.lane = lane
            req.state = RUNNING
            req.pool_len = 0  # set by the engine's prefill
            req.cached_len = len(hits) * self.pool.block_size
            req.prefix_cached_tokens += req.cached_len
            if req.ttft_cached_tokens is None:  # first admission
                req.ttft_cached_tokens = req.cached_len
            req._admit_seq = next(self._admit_counter)
            if req.trace_id is None:  # one trace id per request lifetime
                req.trace_id = f"r{req.request_id}"
            self.lanes[lane] = req
            self.events.append(("admit", req.request_id, lane))
            if hits:
                self.events.append(
                    ("prefix_hit", req.request_id, req.cached_len))
            # latency attribution (always on; engine stamps _t_mark at
            # submit and preempt): the wait that just ended is queue
            # time on a first admission, preempted time on a requeue
            if req._t_mark is not None:
                now = time.perf_counter()
                wait_ms = (now - req._t_mark) * 1e3
                if req.preemptions:
                    req.preempted_ms += wait_ms
                else:
                    req.queue_ms += wait_ms
                req._t_mark = now
            admitted.append(req)
        return admitted

    def _chain_keys(self, req: Request) -> list:
        """``prefix_keys`` over the request's CURRENT prefill context,
        memoized on the request (see ``Request._pkeys``): a blocked
        admission retrying every step, and the post-prefill publish,
        reuse one hash pass instead of rehashing per call."""
        ctx = len(req.prefill_tokens)
        if req._pkeys is None or req._pkeys[0] != ctx:
            req._pkeys = (ctx, prefix_keys(req.prefill_tokens,
                                           self.pool.block_size))
        return req._pkeys[1]

    def publish_prefix(self, req: Request) -> None:
        """Index ``req``'s full, frozen context blocks (engine calls
        this AFTER the lane's prefill wrote their K/V — publishing
        earlier would let a same-round admission read unwritten
        blocks). Blocks that arrived via the prefix cache re-publish as
        no-ops (same chain key, same block); on a key another lane
        published first, this lane's copy just stays private."""
        if not self.prefix_cache:
            return
        for i, key in enumerate(self._chain_keys(req)):
            self.pool.publish(key, req.blocks[i], req)

    # -- growth / preemption -------------------------------------------------

    def running(self) -> list:
        """Active requests in admission (FCFS) order — the order
        ensure_capacity must walk so older requests grab blocks first."""
        return sorted((r for r in self.lanes if r is not None),
                      key=lambda r: r._admit_seq)

    def ensure_capacity(self, req: Request, on_preempt=None) -> bool:
        """Grow ``req.blocks`` to cover its next decode write (position
        ``pool_len``). When the pool is dry, preempt the newest runner —
        possibly ``req`` itself when IT is the newest. Returns False iff
        ``req`` was preempted (caller drops it from this round)."""
        need = blocks_needed(req.pool_len + 1, self.pool.block_size)
        while len(req.blocks) < need:
            got = self.pool.alloc(need - len(req.blocks), req)
            if got is not None:
                req.blocks.extend(got)
                return True
            victims = [r for r in self.running() if r is not req]
            if victims and victims[-1]._admit_seq > req._admit_seq:
                self.preempt(victims[-1], on_preempt)
            else:
                self.preempt(req, on_preempt)
                return False
        return True

    def grow_for_draft(self, req: Request, n: int) -> int:
        """Best-effort block growth for ``n`` speculative draft
        positions beyond the next decode write (which
        :meth:`ensure_capacity` already covered). Returns how many
        draft positions are actually backed (0..n) after clamping to
        the lane's table / ``max_seq_len`` ceiling and to what the
        FREE LIST can hand out RIGHT NOW: speculation is opportunistic,
        so unlike ensure_capacity this never preempts a runner (a dry
        pool just trims the draft) and never reclaims a cold cached
        prefix (``reclaim_cold=False`` — evicting an index entry to
        back a guess would trade real prefill savings for speculative
        ones). The engine returns the unused tail via
        :meth:`release_draft_blocks` after every verify round. Engine
        calls walk requests in FCFS order, so older lanes claim draft
        headroom first — deterministic, like every other allocation
        decision."""
        if n <= 0:
            return 0
        bs = self.pool.block_size
        ceiling = min(self.blocks_per_lane * bs, self.max_seq_len)
        n = min(n, ceiling - (req.pool_len + 1))
        if n <= 0:
            return 0
        need = blocks_needed(req.pool_len + 1 + n, bs)
        grown = 0
        while len(req.blocks) < need:
            # free list only: a draft must never reclaim a COLD cached
            # prefix (evicting its index entry forever) to back a guess
            got = self.pool.alloc(1, req, reclaim_cold=False)
            if got is None:
                break
            req.blocks.extend(got)
            grown += 1
        if grown:
            self.events.append(("draft_grow", req.request_id, grown))
        return max(0, min(n, len(req.blocks) * bs - req.pool_len - 1))

    def release_draft_blocks(self, req: Request) -> int:
        """Return a lane's unused speculative tail blocks — anything
        past the next decode write — to the pool. The engine calls this
        after a verify round rewound ``pool_len`` past rejected drafts,
        which is what makes :meth:`grow_for_draft`'s no-harm contract
        real: a rejected draft leaves NO allocation pressure behind, so
        speculation can never cause a preemption plain decode wouldn't
        have. Tail blocks past the context are always lane-private
        (publish covers only full context blocks), so the free is a
        plain refcount-1 release. Returns the blocks freed."""
        need = blocks_needed(req.pool_len + 1, self.pool.block_size)
        extra = req.blocks[need:]
        if extra:
            self.pool.free(extra, req)
            del req.blocks[need:]
            self.events.append(
                ("draft_release", req.request_id, len(extra)))
        return len(extra)

    def preempt(self, req: Request, on_preempt=None) -> None:
        """Evict a runner: free its blocks, requeue at the waiting FRONT
        (it was admitted before everything behind it — FCFS is preserved
        because victims are always the newest runners, and multiple
        same-round victims re-enter newest-first, so appendleft restores
        arrival order)."""
        self.pool.free(req.blocks, req)
        req.blocks = []
        self.lanes[req.lane] = None
        req.lane = None
        req.pool_len = 0
        req.cached_len = 0
        req.state = WAITING
        req.preemptions += 1
        self.waiting.appendleft(req)
        self.events.append(("preempt", req.request_id, None))
        # attribution: on-lane time up to the eviction bills to decode
        # (the request was holding a lane); the preempt -> re-admission
        # wait that starts NOW bills to preempted_ms at the next admit
        if req._t_mark is not None:
            now = time.perf_counter()
            req.decode_ms += (now - req._t_mark) * 1e3
            req._t_mark = now
        if on_preempt is not None:
            on_preempt(req)

    # -- reclamation ---------------------------------------------------------

    def finish(self, req: Request) -> None:
        """Reclaim a finished lane: KV blocks and the lane slot return to
        the pool immediately (the eviction the admission loop feeds on)."""
        self.pool.free(req.blocks, req)
        req.blocks = []
        self.lanes[req.lane] = None
        req.lane = None
        req.state = FINISHED
        self.events.append(("finish", req.request_id, None))

    # -- state ---------------------------------------------------------------

    def has_running(self) -> bool:
        return any(r is not None for r in self.lanes)

    def has_work(self) -> bool:
        return bool(self.waiting) or self.has_running()

    @property
    def lanes_occupied(self) -> int:
        return sum(1 for r in self.lanes if r is not None)
