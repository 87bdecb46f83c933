"""The port's captured-graph cache (``paddle_tpu_torch/jit/exec_cache.py``)
and the serving engine's graph keys, on the CPU.

A CUDA graph needs the card, so here the capture itself is stubbed
(``tests/test_torch_gpu.py`` captures and replays real ones); what is
held is the cache around it, as the reference's in-memory tier behaves:
equal keys hit, any changed field misses, the full key repr guards a
hash collision, the map is bounded least recently used first, ``stats``
and ``clear`` work, and a replay adds the captured kernel-wrapper calls
to their counters. The engine's keys name the reference's fields plus
the buffers a graph binds, and a second engine of the same geometry
takes the first one's pools, so its keys are equal.
"""
import gc

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import exec_cache
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import ServingConfig, ServingEngine


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def captures(monkeypatch):
    """Stub the capture: record its label, run ``fn`` once for its
    output, count one call of a watched wrapper."""
    labels = []

    def capture(fn, inputs, label, counters):
        labels.append(label)
        return _Graph(), fn(**inputs), {w: 1 for w in counters}

    monkeypatch.setattr(exec_cache, "_capture", capture)
    exec_cache.clear()
    yield labels
    exec_cache.clear()


_KEY = {"kind": "serving_decode", "gen_cfg": (4, 4, 64, 1e4, 1e-6,
                                              "float32", 0),
        "pool": ((2, 9, 2, 4, 16), "torch.float32"), "kv_int8": False,
        "int8_weights": False, "lanes": 3, "m": 4, "paged": True}


def _get(key, label="decode", counters=()):
    x = torch.zeros(3)
    return exec_cache.get_or_capture(key, lambda flat: flat + 1,
                                     {"flat": x}, label, counters)


def test_equal_keys_hit(captures):
    first = _get(_KEY)
    again = _get({k: _KEY[k] for k in reversed(list(_KEY))})  # same fields
    assert again is first and captures == ["decode"]
    st = exec_cache.stats()
    assert (st["captures"], st["hits"], st["mem_entries"]) == (1, 1, 1)
    torch.testing.assert_close(first.output, torch.ones(3))


@pytest.mark.parametrize("field,value", [
    ("kind", "serving_verify"), ("gen_cfg", (4, 2, 64, 1e4, 1e-6,
                                             "float32", 0)),
    ("pool", ((2, 9, 2, 4, 16), "torch.int8")), ("kv_int8", True),
    ("int8_weights", True), ("lanes", 4), ("m", 5), ("paged", False),
])
def test_any_changed_field_misses(captures, field, value):
    first = _get(_KEY)
    other = _get({**_KEY, field: value})
    assert other is not first and len(captures) == 2
    assert exec_cache.stats()["hits"] == 0


def test_full_repr_guards_a_hash_collision(captures, monkeypatch):
    monkeypatch.setattr(exec_cache, "key_hash",
                        lambda key: (repr(exec_cache._freeze(key)), "same"))
    first = _get(_KEY)
    other = _get({**_KEY, "lanes": 9})
    assert other is not first and len(captures) == 2
    assert _get({**_KEY, "lanes": 9}) is other


def test_memory_tier_is_bounded(captures, monkeypatch):
    monkeypatch.setattr(exec_cache, "_MAX_MEM_ENTRIES", 2)
    a = _get({**_KEY, "m": 1})
    _get({**_KEY, "m": 2})
    assert _get({**_KEY, "m": 1}) is a  # a is now the most recent
    _get({**_KEY, "m": 3})  # evicts m=2, the least recently used
    assert exec_cache.stats()["mem_entries"] == 2
    assert _get({**_KEY, "m": 1}) is a
    _get({**_KEY, "m": 2})
    assert captures.count("decode") == 4


def test_clear_and_stats(captures):
    _get(_KEY)
    _get(_KEY)
    st = exec_cache.stats()
    assert (st["captures"], st["hits"]) == (1, 1)
    assert st["capture_ms"] >= 0.0
    exec_cache.clear()
    assert exec_cache.stats() == {"captures": 0, "hits": 0,
                                  "capture_ms": 0.0, "mem_entries": 0}
    _get(_KEY)
    assert len(captures) == 2


def test_replay_adds_the_captured_calls(captures):
    def wrapper():
        pass

    wrapper.launches = 5
    entry = _get(_KEY, counters=(wrapper,))
    assert entry.calls == {wrapper: 1} and wrapper.launches == 5
    for _ in range(3):
        entry.replay()
    assert wrapper.launches == 8 and entry.graph.replays == 3


def test_array_spec():
    t = torch.zeros(2, 3, dtype=torch.int8)
    assert exec_cache.array_spec(t) == ((2, 3), "torch.int8", "cpu")
    assert exec_cache.array_spec(t) == exec_cache.array_spec(t.clone())
    assert exec_cache.array_spec(t) != exec_cache.array_spec(t.float())


# -- the engine's keys --------------------------------------------------------

_GEOM = dict(max_lanes=3, block_size=2, num_blocks=12, prefill_chunk=4,
             max_seq_len=20)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))


def _keys(model, **kw):
    eng = ServingEngine(model, ServingConfig(**{**_GEOM, **kw}),
                        device="cpu")
    return eng, {ph: eng._graph_key(ph) for ph in eng._layouts}


def test_engine_keys_name_the_reference_fields(model):
    eng, keys = _keys(model)
    assert sorted(keys) == ["decode", "prefill", "verify"]
    for phase, key in keys.items():
        assert key["kind"] == f"serving_{phase}"
        assert key["pool"] == (tuple(eng._kpool.shape),
                               str(eng._kpool.dtype))
        assert key["lanes"] == 3 and key["m"] == eng.blocks_per_lane
        assert key["gen_cfg"] == eng._gcfg._key()
        assert key["pool_ptrs"] == [eng._kpool.data_ptr(),
                                    eng._vpool.data_ptr()]
    assert keys["prefill"]["chunk"] == 4 and keys["verify"]["k"] == 4
    assert keys["decode"]["paged"] is True
    _, no_spec = _keys(model, spec_k=0)
    assert sorted(no_spec) == ["decode", "prefill"]
    # the CPU runs the phases eagerly: nothing is captured
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.run()
    assert eng.counters["graph_captures"] == eng.counters[
        "graph_replays"] == 0
    assert eng.stats()["graphs"] is False


def test_second_engine_takes_the_pools_and_keys(model):
    eng, keys = _keys(model)
    ptr = eng._kpool.data_ptr()
    eng._kpool.fill_(3.0)
    live, live_keys = _keys(model)  # the first is alive: its own pools
    assert live._kpool.data_ptr() != ptr
    assert live_keys["decode"] != keys["decode"]
    del eng, live
    gc.collect()
    again, again_keys = _keys(model)  # takes the first one's pools
    assert again._kpool.data_ptr() == ptr and again_keys == keys
    assert not again._kpool.any()  # a reused pool starts zeroed


@pytest.mark.parametrize("field,value", [
    ("kv_int8", True), ("int8_weights", True), ("max_lanes", 4),
    ("prefill_chunk", 8), ("spec_k", 2), ("paged", "off"),
    ("max_seq_len", 24),
])
def test_engine_keys_change_with_each_field(model, field, value):
    base, keys = _keys(model)
    other, other_keys = _keys(model, **{field: value})
    for phase in other_keys:
        key = {**other_keys[phase], "pool_ptrs": keys[phase]["pool_ptrs"],
               "params": keys[phase]["params"]}
        if field == "int8_weights" or field == "kv_int8":
            assert other_keys[phase][field] is True
        if phase == "decode" and field in ("prefill_chunk", "spec_k"):
            assert key == keys[phase]  # fields the decode program lacks
        elif phase == "prefill" and field in ("spec_k", "paged"):
            assert key == keys[phase]
        elif phase == "verify" and field in ("prefill_chunk", "paged"):
            assert key == keys[phase]
        else:
            assert key != keys[phase], (phase, field)


def test_pool_is_renewed_when_its_last_graph_is_freed(monkeypatch):
    """The shared pool's handle is dropped once every graph captured into
    it is freed: the allocator refuses to begin a capture into a pool
    none of whose graphs lives while its tensors do (a collected
    ``TrainStep`` whose model keeps the gradients its graph made)."""
    monkeypatch.setattr(exec_cache, "_pool", (0, 7))
    first, second = _Graph(), _Graph()
    exec_cache._track(first, (0, 7))
    exec_cache._track(second, (0, 7))
    del first
    gc.collect()
    assert exec_cache._pool == (0, 7)  # one graph of it still lives
    del second
    gc.collect()
    assert exec_cache._pool is None and (0, 7) not in exec_cache._pool_graphs
