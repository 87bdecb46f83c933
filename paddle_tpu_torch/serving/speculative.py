"""Speculative-decoding drafters for the serving engine.

Counterpart of ``paddle_tpu/serving/speculative.py``, copied without
its monitor slot. Host-side token proposal: a :class:`Drafter` looks at
one lane's known context (prompt + every generated token, the pending
one included) and proposes up to ``k`` continuation tokens. The engine
then scores all lanes' proposals in ONE verify step (shape
``[lanes, k+1]``) and accepts each lane's longest prefix that matches
the model's own greedy choices, plus one bonus token — the greedy output
stream is identical to plain decode, only the number of decode rounds
changes.

The default drafter is **prompt-lookup n-gram matching** (the
draft-model-free scheme of arXiv:2304.04487 / vLLM's ``[ngram]``
speculator): the lane's most recent tokens are matched against its own
earlier context, and the tokens that followed the most recent earlier
occurrence become the draft.

Determinism contract: drafting feeds the scheduler's replayable event
stream, so a drafter must be a pure function of the tokens it is shown
— no RNG, no clocks, no hash()-ordered iteration.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Drafter", "NgramDrafter"]

_EMPTY = np.zeros((0,), np.int32)


class Drafter:
    """Draft-proposal protocol: subclass (or duck-type) with
    :meth:`propose`. The slot a learned draft model would fill — the
    engine only ever calls this one method, host-side, between compiled
    steps, so a model-backed drafter just runs its own (cheap) forward
    here and returns tokens."""

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens for a lane whose
        known context is ``tokens`` (1-D int array: prompt + generated,
        pending token last). Return an empty array to skip speculation
        for this lane this round. MUST be deterministic in ``tokens``
        (see module docstring)."""
        raise NotImplementedError

    def observe(self, tokens: np.ndarray, accepted: int) -> None:
        """Optional feedback hook: the engine reports how many of the
        last proposal's tokens were accepted. Default: ignore."""


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the context's tail n-gram.

    Longest n-gram first (``max_ngram`` down to ``min_ngram``): a longer
    match is stronger evidence the context is repeating. Among equal
    n-grams the MOST RECENT earlier occurrence wins — locality beats
    antiquity, and "last match" is as deterministic as "first". Pure
    numpy over a few-hundred-token array: microseconds per lane, far
    under one decode round.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, tokens, k: int) -> np.ndarray:
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32)
                                    .reshape(-1))
        n = int(toks.size)
        if k <= 0 or n < 2:
            return _EMPTY
        for ng in range(min(self.max_ngram, n - 1),
                        self.min_ngram - 1, -1):
            pattern = toks[n - ng:]
            # candidate starts 0..n-ng-1: every window that ends before
            # the tail n-gram itself, so a match always has at least one
            # following token to propose
            windows = np.lib.stride_tricks.sliding_window_view(
                toks, ng)[:n - ng]
            hits = np.nonzero((windows == pattern).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + ng  # most recent occurrence
                return toks[start:start + int(k)].copy()
        return _EMPTY

