"""Named random states for dropout under tensor parallelism.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
parallel_layers/random.py`` (Paddle's ``RNGStatesTracker``). Dropout
inside a tensor-parallel region must draw a different mask on each
``mp`` rank and the same one outside it. The reference keeps a JAX key
per name; here a name holds a whole state of the port's dropout
generators (``framework.random``: the attention seed words and each
device's mask generator, explicit ``torch.Generator``\\ s seeded from
the name's seed), and :meth:`RNGStatesTracker.rng_state` swaps it in
around the block and keeps what the block drew.
"""
from __future__ import annotations

import contextlib

from .....framework import random as rng

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "dropout", "MODEL_PARALLEL_RNG"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


def _seeded(seed):
    """The random state :func:`framework.random.seed` makes from
    ``seed``, without touching the current one."""
    outer = rng.get_state()
    rng.seed(seed)
    state = rng.get_state()
    rng.replace_state(outer)
    return state


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.seeds_.add(seed)
        self.states_[name] = _seeded(seed)

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        """Draw from the named state inside the block; the state outside
        is as it was."""
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        outer = rng.get_state()
        rng.replace_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = rng.get_state()
            rng.replace_state(outer)


_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _TRACKER


def model_parallel_random_seed(seed=None):
    """Seed the global state with ``seed`` (the same on every rank:
    dropout outside the tensor-parallel region draws one mask) and the
    tracker's ``model_parallel_rng`` with ``seed + 1024 + mp rank``. The
    reference adds no rank: its mask is one global array, whose shards
    differ; here each rank draws its own shard's mask, so each needs its
    own seed (rank 0 takes the reference's)."""
    import random as pyrandom

    from ...base.topology import get_hcg

    seed = seed if seed is not None else pyrandom.randint(0, 2**31 - 1)
    hcg = get_hcg()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    _TRACKER.reset()
    rng.seed(seed)
    _TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)


def dropout(x, p=0.5, axis=None, rng_name=MODEL_PARALLEL_RNG, training=True,
            mode="upscale_in_train", name=None):
    """``F.dropout`` drawing its mask from the tracker's named state."""
    from .....nn import functional as F

    if not training or p == 0.0:
        return x
    with _TRACKER.rng_state(rng_name):
        return F.dropout(x, p, axis=axis, training=training, mode=mode)
