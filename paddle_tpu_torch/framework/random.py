"""Global random state for dropout.

Counterpart of ``paddle_tpu/framework/random.py``. There a stateful key
source splits a fresh JAX key for every consumer (``next_key``), and the
attention op hands its key's raw uint32 words to the flash kernel as
its dropout seed (``nn/functional/attention.py:78-83``). Here one seeded
CPU ``torch.Generator`` plays the key source:

- :func:`next_seed_words` draws the two seed words of one attention
  call's counter-hash dropout. The generator lives on the host, so a
  draw costs no device synchronisation, and a card run and a CPU run
  seeded alike draw the same words (the hash is device-independent);
- :func:`generator` gives the generator that ``F.dropout`` draws its
  Bernoulli masks from on a device, seeded from the same seed. CPU and
  CUDA generators give different streams from one seed.

:func:`seed` resets all of them, as ``paddle.seed`` does.

:func:`draws` counts the draws of both kinds, so a caller can tell
whether a function drew random numbers (``jit.TrainStep`` runs a step
that does eagerly: a CUDA graph would freeze its seed words);
:func:`get_state` and :func:`set_state` save and restore every
generator, so a step can be replayed with its own random numbers (the
nan_check replay).

The reference's names for the same (``random.py:89-107``,
``compat.py:201-211``): :func:`get_rng_state` and :func:`set_rng_state`
take and give the whole state (a dict of generator states, where the
reference's is a JAX key); :func:`rng_scope` runs a block from a given
state and puts the state before it back; ``get_cuda_rng_state`` and
``set_cuda_rng_state`` are the same state in a one-element list. The
same state gives the same draws: dropout masks, the random ops and the
seed words of kernels 1-6.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["seed", "next_seed_words", "generator", "draws", "note_draw",
           "get_state", "set_state", "replace_state", "get_rng_state",
           "set_rng_state", "rng_scope", "get_cuda_rng_state",
           "set_cuda_rng_state"]

_state: dict = {}
_draws = [0]


def seed(value: int) -> None:
    """Reset the dropout seed words and every device generator."""
    _state.clear()
    _state["seed"] = int(value)
    _state["words"] = torch.Generator("cpu").manual_seed(int(value))


def _words() -> torch.Generator:
    if "words" not in _state:
        seed(0)
    return _state["words"]


def next_seed_words() -> tuple:
    """Two int32 words for one call's in-kernel dropout (the reference's
    ``int32[2]`` seed operand), from the host generator."""
    note_draw()
    w = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int64,
                      generator=_words())
    return int(w[0]), int(w[1])


def generator(device) -> torch.Generator:
    """The generator of ``device`` for dropout masks, made at first use
    and seeded from :func:`seed`'s value plus one (so it is not the seed
    words' stream on the CPU)."""
    _words()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if key not in _state:
        _state[key] = torch.Generator(dev).manual_seed(_state["seed"] + 1)
    return _state[key]


def note_draw() -> None:
    """Count one draw (the dropout ops call it)."""
    _draws[0] += 1


def draws() -> int:
    """How many draws were made so far in this process."""
    return _draws[0]


def get_state() -> dict:
    """Every generator's state (the seed words' and each device's)."""
    _words()
    return {k: (v.get_state() if isinstance(v, torch.Generator) else v)
            for k, v in _state.items()}


def set_state(state: dict) -> None:
    """Restore :func:`get_state`'s snapshot."""
    for k, v in state.items():
        if k == "seed":
            _state[k] = v
        else:
            if k not in _state:
                _state[k] = (torch.Generator("cpu") if k == "words"
                             else torch.Generator(torch.device(k)))
            _state[k].set_state(v)


def replace_state(state: dict) -> None:
    """Make :func:`get_state`'s snapshot the whole random state: a
    generator made after the snapshot is dropped, so its next use starts
    it from the seed again, as it started then (a replay of a block that
    made it)."""
    _state.clear()
    set_state(state)


def get_rng_state() -> dict:
    """The whole random state (``paddle.get_rng_state``)."""
    return get_state()


def set_rng_state(state: dict) -> None:
    """Make ``state`` (from :func:`get_rng_state`) the whole random
    state: the draws that followed it follow again."""
    replace_state(state)


@contextlib.contextmanager
def rng_scope(state):
    """Draw from ``state`` within the block; the state before the block
    is put back after it."""
    before = get_state()
    replace_state(state)
    try:
        yield
    finally:
        replace_state(before)


def get_cuda_rng_state() -> list:
    """:func:`get_rng_state` in a one-element list, as the reference
    gives it."""
    return [get_rng_state()]


def set_cuda_rng_state(state) -> None:
    set_rng_state(state[0] if isinstance(state, (list, tuple)) else state)
