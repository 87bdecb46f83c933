"""The port's distributed checkpoint (``distributed/checkpoint.py``) held
against the JAX package's: the same format 2 files, read and written by
either package, at another layout.

In this process: a checkpoint the port writes (fp32, bf16, a number, a
region streamed in chunks, async) reads back bit for bit in the
reference, and the reference's (fp32 and bf16, from a tensor-parallel
mp 2 weight whose regions are its shards) in the port; the async
snapshot is the value at the call; the index appears at the join; a
failed writer raises at the join without deadlocking the producer;
``is_complete`` refuses a torn index, a truncated region file and a
missing one; a missing key and a wrong shape raise; v1 indexes read.
``framework.io``'s ``save``/``load`` files move between the packages
both ways.

Across layouts, with two ranks spawned on gloo (each world size once; a
``file://`` store under the test's directory; the children import
neither ``jax`` nor ``paddle_tpu``), the tiny Llama in bf16:

- the reference's one-device checkpoint loads into mp 2 ranks (the
  fused qkv and gate/up weights cut segment by segment) and into ZeRO
  ``p_g_os`` ranks at sharding 2, bit for bit;
- the mp 2 ranks save (async; one region per segment of a fused weight),
  and one rank loads it, and the reference reads it, bit for bit;
- the ZeRO ranks take one ``AdamW(multi_precision=True)`` step and save
  parameters, masters and moments (``optimizer_state``, async); one
  rank loads them into the plain model and optimizer, bit for bit
  against the ranks' gathered state, and the next step's loss is the
  ZeRO ranks' next loss.
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.distributed import spawn

B, S, V = 4, 16, 128


def _bits(t):
    """A tensor's bits as numpy (bfloat16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int64)
    labels = rng.randint(0, V, (B, S)).astype(np.int64)
    labels[0, :3] = -100
    return ids, labels


# -- one process ------------------------------------------------------------------


def _sample():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(6, 4, generator=g),
            "h": torch.randn(5, 3, generator=g).to(torch.bfloat16),
            "big": torch.randn(64, 32, generator=g),
            "step": 7}


@pytest.mark.parametrize("async_save", [False, True])
def test_port_checkpoint_reads_in_the_reference(tmp_path, monkeypatch,
                                                async_save):
    from paddle_tpu.distributed import checkpoint as jck

    monkeypatch.setattr(tck, "_CHUNK_BYTES", 1024)  # "big" in chunks
    sd = _sample()
    t = tck.save_state_dict(sd, str(tmp_path), async_save=async_save)
    if async_save:
        assert not os.path.exists(tmp_path / "index.json")  # at the join
        t.join()
    assert tck.is_complete(str(tmp_path))
    assert jck.is_complete(str(tmp_path))
    index = json.loads((tmp_path / "index.json").read_text())
    assert index["format"] == 2
    assert index["tensors"]["h"]["dtype"] == "bfloat16"
    assert index["tensors"]["w"]["shards"][0]["file"] == "w.r0x0.npy"
    got = jck.load_checkpoint(str(tmp_path))
    for k in ("w", "h", "big"):
        np.testing.assert_array_equal(_ref_bits(got[k]), _bits(sd[k]))
    assert int(got["step"]) == 7
    back = tck.load_checkpoint(str(tmp_path))
    for k in ("w", "h", "big"):
        assert back[k].dtype == sd[k].dtype
        assert torch.equal(back[k], sd[k])


def test_reference_checkpoint_reads_in_the_port(tmp_path):
    """The reference's mp 2 column-parallel weight is written as its two
    shard regions; fp32 and bf16 both load whole, bit for bit."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.fleet.meta_parallel import (
        ColumnParallelLinear,
    )

    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 4, "mp_degree": 2, "pp_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    try:
        pt.seed(5)
        lin = ColumnParallelLinear(8, 16, gather_output=True)
        w = np.asarray(lin.weight.numpy())
        h = lin.weight.astype("bfloat16")
        jck.save_state_dict({"w": lin.weight, "h": h}, str(tmp_path))
        h_bits = _ref_bits(np.asarray(h._data))
    finally:
        jenv.reset_env()
    files = sorted(os.listdir(tmp_path))
    assert "w.r0x0.npy" in files and "w.r0x8.npy" in files
    dest = {"w": torch.zeros(8, 16), "h": torch.zeros(8, 16,
                                                       dtype=torch.bfloat16)}
    tck.load_state_dict(dest, str(tmp_path))
    np.testing.assert_array_equal(_bits(dest["w"]), w)
    np.testing.assert_array_equal(_bits(dest["h"]), h_bits)


def test_async_snapshot_is_the_value_at_the_call(tmp_path):
    src = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    want = src.clone()
    t = tck.save_state_dict({"x": src}, str(tmp_path), async_save=True)
    src.fill_(-1.0)
    tck.wait_all()
    assert t.error is None
    assert torch.equal(tck.load_checkpoint(str(tmp_path))["x"], want)


def test_async_writer_failure_raises_at_join(tmp_path, monkeypatch):
    def bad_save(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(tck.np, "save", bad_save)
    vals = {f"t{i}": torch.zeros(64, 64) for i in range(8)}
    with pytest.raises(RuntimeError, match="writer failed"):
        # a tiny budget: the producer blocks on the queue and is released
        # by the failure
        t = tck.save_state_dict(vals, str(tmp_path), async_save=True,
                                max_inflight_bytes=16384)
        t.join()
    tck._pending.clear()
    assert not os.path.exists(tmp_path / "index.json")


def test_is_complete_refuses_torn_checkpoints(tmp_path):
    tck.save_state_dict(_sample(), str(tmp_path))
    assert tck.is_complete(str(tmp_path))
    index = tmp_path / "index.json"
    text = index.read_text()
    index.write_text(text[:len(text) // 2])  # a torn index
    assert not tck.is_complete(str(tmp_path))
    index.write_text(text)
    region = tmp_path / "w.r0x0.npy"
    data = region.read_bytes()
    region.write_bytes(data[:-8])  # a truncated region
    assert not tck.is_complete(str(tmp_path))
    region.unlink()  # a missing one
    assert not tck.is_complete(str(tmp_path))


def test_missing_key_and_wrong_shape_raise(tmp_path):
    tck.save_state_dict({"x": torch.zeros(2, 2)}, str(tmp_path))
    with pytest.raises(KeyError, match="'y'"):
        tck.load_state_dict({"y": torch.zeros(2, 2)}, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        tck.load_state_dict({"x": torch.zeros(3, 3)}, str(tmp_path))


def test_v1_index_reads(tmp_path):
    np.save(tmp_path / "x.npy", np.arange(6, dtype=np.float32))
    (tmp_path / "index.json").write_text(json.dumps(
        {"format": 1, "tensors": {"x": {"shape": [6], "dtype": "float32",
                                        "file": "x.npy"}}}))
    dest = {"x": torch.zeros(6)}
    tck.load_state_dict(dest, str(tmp_path))
    assert torch.equal(dest["x"], torch.arange(6, dtype=torch.float32))


@pytest.mark.parametrize("protocol", [2, 4])
def test_framework_io_files_load_in_either_package(tmp_path, protocol):
    """``framework.io``'s pickles: the port's load in the reference (a
    parameter as a parameter, bf16 as bf16) and the reference's in the
    port."""
    import paddle_tpu as pt
    from paddle_tpu.framework import io as jio

    from paddle_tpu_torch.framework import io as tio

    sd = {"w": torch.nn.Parameter(torch.randn(3, 4)),
          "h": torch.randn(5).to(torch.bfloat16), "n": 3,
          "nested": [torch.arange(4), {"k": torch.ones(2)}]}
    tio.save(sd, tmp_path / "port.pdparams", protocol=protocol)
    got = jio.load(str(tmp_path / "port.pdparams"))
    assert type(got["w"]).__name__ == "EagerParamBase"
    np.testing.assert_array_equal(np.asarray(got["w"].numpy()),
                                  sd["w"].detach().numpy())
    np.testing.assert_array_equal(_ref_bits(got["h"]._data), _bits(sd["h"]))
    assert got["n"] == 3
    np.testing.assert_array_equal(np.asarray(got["nested"][0].numpy()),
                                  np.arange(4))
    jio.save({"x": pt.to_tensor(np.arange(6, dtype=np.float32)),
              "y": pt.to_tensor(np.ones(3, np.float32)).astype("bfloat16")},
             str(tmp_path / "ref.pdparams"))
    back = tio.load(tmp_path / "ref.pdparams")
    assert torch.equal(back["x"], torch.arange(6, dtype=torch.float32))
    assert back["y"].dtype == torch.bfloat16
    assert torch.equal(back["y"].float(), torch.ones(3))
    raw = tio.load_from_bytes(tio.save_to_bytes(sd), return_numpy=True)
    np.testing.assert_array_equal(raw["w"], sd["w"].detach().numpy())


# -- across layouts -----------------------------------------------------------------


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=s)


def _model():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                             dtype="bfloat16"),
                            device="cpu")


def _optimizer(model):
    from paddle_tpu_torch.optimizer import AdamW

    return AdamW(learning_rate=1e-3, weight_decay=0.01, multi_precision=True,
                 parameters=list(model.named_parameters()))


def _gathered(model):
    from paddle_tpu_torch.models import gather_jax_layout

    return gather_jax_layout(model)


def _ckpt_worker(root):
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    rank = dist.get_rank()
    out = {}
    # the reference's one-device checkpoint into mp 2, then saved from it
    _fleet(mp=2)
    model = _model()
    tck.load_state_dict(model.state_dict(keep_vars=True), f"{root}/ref")
    out["mp2"] = _gathered(model)
    tck.save_state_dict(model.state_dict(keep_vars=True), f"{root}/mp2",
                        async_save=True)
    tck.wait_all()
    # the same into ZeRO p_g_os at sharding 2, a step, then saved
    _fleet(sharding=2)
    model = _model()
    opt = _optimizer(model)
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    tck.load_state_dict(model.state_dict(keep_vars=True), f"{root}/ref")
    out["zero_loaded"] = _gathered(model)
    ids, labels = (torch.from_numpy(a[rank * 2:rank * 2 + 2])
                   for a in _batch())
    step = TrainStep(model, opt, lambda m, i, l: m(i, l))
    out["first"] = float(step(ids, labels))
    state = {**model.state_dict(keep_vars=True), **tck.optimizer_state(opt)}
    t = tck.save_state_dict(state, f"{root}/zero", async_save=True)
    t.join()
    out["zero_params"] = _gathered(model)
    out["zero_opt"] = {k: (_bits(v) if isinstance(v, torch.Tensor) else v)
                       for k, v in opt.state_dict().items()}
    out["next"] = float(step(ids, labels))
    out["files"] = sorted(os.listdir(f"{root}/mp2"))
    with open(f"{root}/out.{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    """The reference's tiny Llama saved in bf16 at one device, the ranks'
    results, and the directory."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama

    root = tmp_path_factory.mktemp("ckpt")
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    try:
        pt.seed(11)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2))
        bf16 = {n: p.astype("bfloat16") for n, p in jm.named_parameters()}
        jck.save_state_dict(bf16, str(root / "ref"))
        ref = {n: np.asarray(t._data).astype(np.float32)
               for n, t in bf16.items()}
    finally:
        jenv.reset_env()
    spawn(_ckpt_worker, args=(str(root),), nprocs=2)
    ranks = []
    for r in range(2):
        with open(root / f"out.{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, ranks, root


def test_reference_checkpoint_loads_into_mp2_and_zero_ranks(moved):
    ref, ranks, _ = moved
    for o in ranks:
        for key in ("mp2", "zero_loaded"):
            assert o[key].keys() == ref.keys()
            for n, a in ref.items():
                np.testing.assert_array_equal(o[key][n], a, err_msg=n)


def test_mp2_checkpoint_loads_at_one_rank_and_in_the_reference(moved):
    from paddle_tpu.distributed import checkpoint as jck

    ref, ranks, root = moved
    # the fused qkv weight: one region per segment and rank
    qkv = [f for f in ranks[0]["files"]
           if f.startswith("llama.layers.0.self_attn.qkv_proj.weight")]
    assert len(qkv) == 6, qkv
    model = _model()
    tck.load_state_dict(model.state_dict(keep_vars=True), str(root / "mp2"))
    got = jck.load_checkpoint(str(root / "mp2"))
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(), ref[n],
                                      err_msg=n)
        np.testing.assert_array_equal(
            np.asarray(got[n]).astype(np.float32), ref[n], err_msg=n)


def test_zero_checkpoint_loads_at_one_rank(moved):
    """Parameters, masters, moments and step counts from the ZeRO ranks'
    slices, into the plain model and optimizer: bit for bit, and the
    next step is the ZeRO ranks' next step."""
    from paddle_tpu_torch.jit import TrainStep

    _, ranks, root = moved
    model = _model()
    opt = _optimizer(model)
    state = {**model.state_dict(keep_vars=True), **tck.optimizer_state(opt)}
    tck.load_state_dict(state, str(root / "zero"))
    opt.set_state_dict(state)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      ranks[0]["zero_params"][n], err_msg=n)
    sd = opt.state_dict()
    assert sd.keys() == ranks[0]["zero_opt"].keys()
    for k, v in ranks[0]["zero_opt"].items():
        got = sd[k]
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(_bits(got), v, err_msg=k)
        else:
            assert got == v, k
    ids, labels = (torch.from_numpy(a) for a in _batch())
    nxt = float(TrainStep(model, opt, lambda m, i, l: m(i, l))(ids, labels))
    assert abs(nxt - ranks[0]["next"]) <= 1e-3  # bf16, 2 ranks vs 1
    assert ranks[0]["next"] == ranks[1]["next"]
