"""The port's ZeRO (``distributed.sharding.group_sharded_parallel``) held
against the JAX package's on its virtual CPU mesh, and against the
port's own unsharded data parallelism.

The tiny Llama (2 layers, hidden 64, vocab 128), fp32, from the
reference's weights, on one b4 x s16 batch (ignored labels in the first
rows, so the ranks' counts differ), 3 steps of ``AdamW`` with
``ClipGradByGlobalNorm(1.0)`` (or ``Lamb`` with it), eager. The
reference runs ``group_sharded_parallel`` at the config's level on its
mesh, in this process; the port's ranks are spawned on gloo (each world
size once; a ``file://`` store under the test's directory; the children
import neither ``jax`` nor ``paddle_tpu``), each rank its chunk of the
batch over ``dp x sharding``:

- ``sharding 2`` at ``os``, ``os_g``, ``p_g_os``, ``os_g`` with
  ``offload``, and ``p_g_os`` with ``Lamb``; ``dp 2`` with sharding 1
  (ZeRO over dp) at ``os_g``; ``dp 2 x sharding 2`` at ``os_g`` and
  ``p_g_os``; and under tensor parallelism ``mp 2 x sharding 2`` at
  ``os_g``, ``p_g_os`` and ``p_g_os`` with ``Lamb``, and ``mp 2 x dp 2``
  (ZeRO over dp) at ``os_g``: ZeRO cuts the rank's mp piece;
- held: the losses against the reference within ``TOL`` and against the
  port's unsharded run (``fleet.distributed_model`` over the same
  ranks and mp) within
  ``SELF_TOL``; the parameters after the steps within ``PARAM_TOL`` of
  the reference's and ``SELF_TOL`` of the port's unsharded ones; each
  parameter's states are cut as the reference's ``_sharded_put`` places
  them on its mesh (its spec on the axes of degree > 1: the first dim
  the layer names no axis on, even at degree 1, that the degree
  divides), and under ``p_g_os`` the parameter itself; each rank holds
  only its slices (the moments' shapes, and under ``p_g_os`` the
  parameters'); ``state_dict`` is whole and the same on every rank and
  ``set_state_dict`` cuts it back bit for bit; under offload each
  update sees one parameter at a time;
- ``save_group_sharded_model`` writes files that the reference's
  ``paddle.load`` reads (at sharding 2 and in every config under mp):
  its parameters load into the reference model and give its loss;
- a sharded checkpoint (``distributed.checkpoint``) of the mp 2 x
  sharding 2 ranks records both cuts and loads back at that layout and
  at one rank;
- ZeRO at world size 1 is the identity.
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

B, S, V = 4, 16, 128
TOL = 1e-5
# ZeRO against the port's own unsharded dp run: the same sums in another
# order (a reduce-scatter and a dp all-reduce for one all-reduce)
SELF_TOL = 1e-6
# as tests/test_torch_fleet_llama.py: Adam moves each weight by about
# lr * sign(g) at first, so a gradient near 0 whose sign the two
# packages' summation orders flip moves it ~2 lr apart
PARAM_TOL = 2e-3
STEPS = 3
# name: (dp, mp, sharding, level, offload, optimizer)
CONFIGS = {
    "sh2_os": (1, 1, 2, "os", False, "adamw"),
    "sh2_os_g": (1, 1, 2, "os_g", False, "adamw"),
    "sh2_p_g_os": (1, 1, 2, "p_g_os", False, "adamw"),
    "sh2_offload": (1, 1, 2, "os_g", True, "adamw"),
    "sh2_lamb": (1, 1, 2, "p_g_os", False, "lamb"),
    "dp2_os_g": (2, 1, 1, "os_g", False, "adamw"),
    "dp2_sh2_os_g": (2, 1, 2, "os_g", False, "adamw"),
    "dp2_sh2_p_g_os": (2, 1, 2, "p_g_os", False, "adamw"),
    "mp2_sh2_os_g": (1, 2, 2, "os_g", False, "adamw"),
    "mp2_sh2_p_g_os": (1, 2, 2, "p_g_os", False, "adamw"),
    "mp2_dp2_os_g": (2, 2, 1, "os_g", False, "adamw"),
    "mp2_sh2_lamb": (1, 2, 2, "p_g_os", False, "lamb"),
}
# the port's unsharded runs each config is held against
PLAIN = {"plain_2": (1, 1, 2, None, False, "adamw"),
         "plain_2_lamb": (1, 1, 2, None, False, "lamb"),
         "plain_4": (2, 1, 2, None, False, "adamw"),
         "plain_mp2_sh2": (1, 2, 2, None, False, "adamw"),
         "plain_mp2_sh2_lamb": (1, 2, 2, None, False, "lamb")}
# one reference run per mesh and optimizer (ZeRO is a layout there)
REFERENCE = {"sh2_p_g_os": ("sh2_os", "sh2_os_g", "sh2_p_g_os",
                            "sh2_offload", "dp2_os_g"),
             "sh2_lamb": ("sh2_lamb",),
             "dp2_sh2_p_g_os": ("dp2_sh2_os_g", "dp2_sh2_p_g_os"),
             "mp2_sh2_p_g_os": ("mp2_sh2_os_g", "mp2_sh2_p_g_os",
                                "mp2_dp2_os_g"),
             "mp2_sh2_lamb": ("mp2_sh2_lamb",)}
# the configs whose ranks save with save_group_sharded_model
SAVED = ("sh2_p_g_os", "mp2_sh2_os_g", "mp2_sh2_p_g_os", "mp2_dp2_os_g",
         "mp2_sh2_lamb")
# the config whose ranks save a sharded checkpoint (distributed.checkpoint)
CHECKPOINTED = "mp2_sh2_p_g_os"


def _plain_of(name):
    """The unsharded run over as many ranks, at the same mp, with the
    same optimizer (ZeRO over dp is held against sharding's, as one
    data-parallel sum)."""
    dp, mp, sh, _, _, opt = CONFIGS[name]
    return next(n for n, (d, m, h, _, _, o) in PLAIN.items()
                if (d * h, m, o) == (dp * sh, mp, opt))


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 4:6] = -100
    return ids, labels


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _run(root, name, spec):
    """One config on this rank: 3 steps, then the state."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.shard import (
        get_sharding, grad_layout, layout_spec,
    )
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model,
    )
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, gather_jax_layout, load_jax_weights,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, Lamb

    dp, mp, sh, level, offload, opt_name = spec
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                        "sharding_degree": sh}
    fleet.init(is_collective=True, strategy=s)
    with open(f"{root}/weights.pkl", "rb") as f:
        weights = pickle.load(f)
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cpu")
    load_jax_weights(model, weights)
    clip = ClipGradByGlobalNorm(1.0)
    named = list(model.named_parameters())
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01, parameters=named,
                grad_clip=clip) if opt_name == "adamw" else \
        Lamb(learning_rate=1e-3, parameters=named, grad_clip=clip)
    if level is None:
        net = fleet.distributed_model(model)
    else:
        model, opt, _ = group_sharded_parallel(model, opt, level=level,
                                               offload=offload)
        net = model
    sizes = []  # (parameters an update sees, parameters staged meanwhile)
    if offload:
        staged = []
        work, park, update = opt._work, opt._park, opt._update

        def _work(p, g, create=True):
            staged.append(id(p))
            return work(p, g, create)

        def _park(p, *a):
            staged.remove(id(p))
            return park(p, *a)

        opt._work, opt._park = _work, _park
        opt._update = lambda w, *a: (sizes.append((len(w), len(staged))),
                                     update(w, *a))
    env = dist.get_env()
    r = env.coords["dp"] * sh + env.coords["sharding"]
    b = B // (dp * sh)
    ids, labels = (torch.from_numpy(a[r * b:(r + 1) * b])
                   for a in _batch())
    step = TrainStep(net, opt, lambda m, i, l: m(i, l))
    out = {"steps": [float(step(ids, labels)) for _ in range(STEPS)],
           "params": gather_jax_layout(model), "sizes": sizes}
    if level is None:
        return out
    out["local"] = {n: tuple(p.shape) for n, p in named}
    out["moments"] = {n: tuple(opt._accumulators[id(p)]["moment1"].shape)
                      for n, p in named}
    out["specs"] = {n: (_spec(get_sharding(p), p.dim()),
                        _spec(layout_spec(grad_layout(p)), p.dim()))
                    for n, p in named}
    sd = opt.state_dict()
    out["state"] = {k: v.numpy() for k, v in sd.items()
                    if isinstance(v, torch.Tensor)}
    opt.set_state_dict(sd)
    again = opt.state_dict()
    out["state_roundtrip"] = all(
        torch.equal(again[k], v) for k, v in sd.items()
        if isinstance(v, torch.Tensor))
    if name in SAVED:
        save_group_sharded_model(model, f"{root}/saved_{name}", opt)
    if name == CHECKPOINTED:
        out["reloaded"] = _checkpoint_round_trip(root, model, opt, spec)
    return out


def _checkpoint_round_trip(root, model, opt, spec):
    """Save a sharded checkpoint (parameters, masters and moments from
    both cuts), then load it into a fresh model and optimizer under the
    same layout: their state gathered whole."""
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, gather_jax_layout,
    )
    from paddle_tpu_torch.optimizer import AdamW

    path = f"{root}/checkpoint"
    tck.save_state_dict({**model.state_dict(keep_vars=True),
                         **tck.optimizer_state(opt)}, path)
    fresh = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cpu")
    again = AdamW(learning_rate=1e-3, weight_decay=0.01,
                  parameters=list(fresh.named_parameters()))
    fresh, again, _ = group_sharded_parallel(fresh, again, level=spec[3])
    state = {**fresh.state_dict(keep_vars=True),
             **tck.optimizer_state(again)}
    tck.load_state_dict(state, path)
    again.set_state_dict(state)
    return {"params": gather_jax_layout(fresh),
            "state": {k: v.numpy() for k, v in again.state_dict().items()
                      if isinstance(v, torch.Tensor)}}


def _spec(spec, ndim):
    """A spec as a tuple of ``ndim`` parts, None or an axis name."""
    parts = tuple(spec or ())
    return parts + (None,) * (ndim - len(parts))


def _zero_worker(root, names):
    _child_setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    for name in names:
        out = _run(root, name, CONFIGS.get(name) or PLAIN[name])
        with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


# -- the reference ----------------------------------------------------------------


def _reference(name):
    """The reference's ZeRO run of ``name`` on its mesh, and the
    weights."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.sharding import group_sharded_parallel
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama

    dp, mp, sh, level, offload, opt_name = CONFIGS[name]
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": 1,
                        "sharding_degree": sh}
    jfleet.init(is_collective=True, strategy=s)
    try:
        pt.seed(11)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2))
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        clip = pt.nn.ClipGradByGlobalNorm(1.0)
        opt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=jm.parameters(), grad_clip=clip) \
            if opt_name == "adamw" else pt.optimizer.Lamb(
                learning_rate=1e-3, parameters=jm.parameters(),
                grad_clip=clip)
        jm, opt, _ = group_sharded_parallel(jm, opt, level=level,
                                            offload=offload)
        data = tuple(pt.to_tensor(a) for a in _batch())
        steps = []
        for _ in range(STEPS):
            loss = jm(*data)
            loss.backward()
            opt.step()
            opt.clear_grad()
            steps.append(float(loss.numpy()))
        ref = {"steps": steps,
               "params": {n: np.asarray(p._data)
                          for n, p in jm.named_parameters()}}
    finally:
        jenv.reset_env()
    return weights, ref


def _reference_specs(dp, mp, sh):
    """Each parameter's spec as the reference's ZeRO places it on the
    ``dp x mp x sharding`` mesh (``_sharded_put`` on the layer's own
    placement: its states, and under ``p_g_os`` the parameter), on the
    axes of degree > 1."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.sharding import group_sharded as jgs
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama

    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": 1,
                        "sharding_degree": sh}
    jfleet.init(is_collective=True, strategy=s)
    degrees = {"dp": dp, "mp": mp, "sharding": sh}
    try:
        pt.seed(11)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2))
        axis = jgs._shard_axis()
        out = {}
        for n, p in jm.named_parameters():
            spec = _spec(jgs._sharded_put(p._data, axis).sharding.spec,
                         p._data.ndim)
            out[n] = tuple(a if a is not None and degrees.get(a, 1) > 1
                           else None for a in spec)
        return out
    finally:
        jenv.reset_env()


def _reference_loss(state):
    """The reference model's loss with ``state`` (a ``paddle.load``ed
    ``model.pdparams``) set."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama

    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1}
    jfleet.init(is_collective=True, strategy=s)
    try:
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2))
        missing, unexpected = jm.set_state_dict(state)
        assert not missing and not unexpected, (missing, unexpected)
        return float(jm(*(pt.to_tensor(a) for a in _batch())).numpy())
    finally:
        jenv.reset_env()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference or None, [each rank's results])}, the reference
    loss of the saved model and the saved directory."""
    root = tmp_path_factory.mktemp("zero")
    refs, weights = {}, None
    for ref_name, names in REFERENCE.items():
        weights, ref = _reference(ref_name)
        refs.update({n: ref for n in names})
    specs = {}
    for name, (dp, mp, sh, *_) in CONFIGS.items():
        if (dp, mp, sh) not in specs:
            specs[(dp, mp, sh)] = _reference_specs(dp, mp, sh)
        refs[name] = {**refs[name], "specs": specs[(dp, mp, sh)]}
    out = {}
    by_world = {2: [], 4: []}
    for name, spec in {**CONFIGS, **PLAIN}.items():
        by_world[spec[0] * spec[1] * spec[2]].append(name)
    for world, names in by_world.items():
        sub = root / f"w{world}"
        os.makedirs(sub)
        with open(sub / "weights.pkl", "wb") as f:
            pickle.dump(weights, f)
        spawn(_zero_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            out[name] = (refs.get(name), ranks)
    out["saved"] = {n: str(root / f"w{np.prod(CONFIGS[n][:3])}"
                           / f"saved_{n}") for n in SAVED}
    out["checkpoint"] = str(root / f"w{np.prod(CONFIGS[CHECKPOINTED][:3])}"
                            / "checkpoint")
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_zero_steps_match_reference_and_unsharded(runs, name):
    ref, ranks = runs[name]
    _, plain = runs[_plain_of(name)]
    for o in ranks:
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(o["steps"], plain[0]["steps"],
                                   atol=SELF_TOL, rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)
            np.testing.assert_allclose(p, plain[0]["params"][n],
                                       atol=SELF_TOL, rtol=0, err_msg=n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_parameter_is_cut_as_the_reference_cuts_it(runs, name):
    """The states' layout (``shard.grad_layout``) on the axes of degree
    > 1 is the reference's spec; under ``p_g_os`` the parameter's
    (``shard.get_sharding``) too, and under ``os``/``os_g`` the
    parameter keeps its tensor-parallel cut alone."""
    ref, ranks = runs[name]
    level = CONFIGS[name][3]
    for o in ranks:
        for pname, (param_spec, state_spec) in o["specs"].items():
            want = ref["specs"][pname]
            assert state_spec == want, (pname, state_spec, want)
            tp = tuple(a if a == "mp" else None for a in want)
            assert param_spec == (want if level == "p_g_os" else tp), \
                (pname, param_spec, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_only_its_slices(runs, name):
    """Each dim the reference's spec names an axis on is cut by that
    axis's degree (ZeRO's dim read from the spec, not taken as the first
    divisible one); the rest stay whole. ``p_g_os`` cuts the parameters
    too; under ``os``/``os_g`` a parameter is its mp piece."""
    dp, mp, sh, level, _, _ = CONFIGS[name]
    degrees = {"dp": dp, "mp": mp, "sharding": sh}
    ref, ranks = runs[name]
    for o in ranks:
        for pname, shape in o["moments"].items():
            full = o["params"][pname].shape
            spec = ref["specs"][pname]
            want = tuple(s // degrees[a] if a else s
                         for s, a in zip(full, spec))
            piece = tuple(s // mp if a == "mp" else s
                          for s, a in zip(full, spec))
            assert any(a not in (None, "mp") for a in spec), pname
            assert shape == want, (pname, shape, full)
            assert o["local"][pname] == (want if level == "p_g_os"
                                         else piece)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_state_dict_is_whole_on_every_rank_and_cuts_back(runs, name):
    _, ranks = runs[name]
    for o in ranks:
        assert o["state_roundtrip"]
        for k, v in o["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k])
            if k.endswith("moment1"):
                assert v.shape == o["params"][k[:-len(".moment1")]].shape


def test_offload_updates_one_parameter_at_a_time(runs):
    """Each update sees one parameter, and only that parameter's master
    and states are staged (taken by ``_work``, not yet written back by
    ``_park``) while it runs."""
    _, ranks = runs["sh2_offload"]
    for o in ranks:
        assert o["sizes"] and {tuple(s) for s in o["sizes"]} == {(1, 1)}


def _saved_loads_in_the_reference(runs, name):
    from paddle_tpu.framework.io import load as jload

    _, ranks = runs[name]
    state = jload(os.path.join(runs["saved"][name], "model.pdparams"))
    for n, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(np.asarray(state[n].numpy()), p)
    opt = jload(os.path.join(runs["saved"][name], "model.pdopt"),
                return_numpy=True)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(opt[k], v)
    assert opt["global_step"] == STEPS
    # the next loss on the saved weights, in the reference
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models import load_jax_weights

    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cpu")
    load_jax_weights(model, ranks[0]["params"])
    ids, labels = (torch.from_numpy(a) for a in _batch())
    want = float(model(ids, labels).detach())
    assert abs(_reference_loss(state) - want) <= TOL


def test_saved_group_sharded_model_loads_in_the_reference(runs):
    _saved_loads_in_the_reference(runs, "sh2_p_g_os")


@pytest.mark.parametrize("name", [n for n in SAVED if n.startswith("mp2")])
def test_saved_model_under_mp_loads_in_the_reference(runs, name):
    """Written whole from both cuts (over the ZeRO axis, then over
    mp)."""
    _saved_loads_in_the_reference(runs, name)


def test_checkpoint_at_mp2_sharding2_records_both_cuts_and_loads(runs):
    """A sharded checkpoint of the ``mp 2 x sharding 2`` ``p_g_os`` ranks
    records both cuts (the index's spec; one region per segment of each
    cut dim), loads back at its own layout on every rank, and at one
    rank into the plain model and optimizer, bit for bit against the
    ranks' gathered state."""
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, gather_jax_layout,
    )
    from paddle_tpu_torch.optimizer import AdamW

    _, ranks = runs[CHECKPOINTED]
    path = runs["checkpoint"]
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)["tensors"]
    qkv = "llama.layers.0.self_attn.qkv_proj.weight"
    assert index[qkv]["spec"] == ["sharding", "mp"]
    assert index[f"{qkv}.moment1"]["spec"] == ["sharding", "mp"]
    # q, k, v on dim 1 over mp, each cut over sharding on dim 0
    assert len(index[qkv]["shards"]) == 3 * 2 * 2
    assert index["llama.embed_tokens.weight"]["spec"] == ["mp", "sharding"]
    for o in ranks:
        for n, p in o["params"].items():
            np.testing.assert_array_equal(o["reloaded"]["params"][n], p,
                                          err_msg=n)
        for k, v in o["state"].items():
            np.testing.assert_array_equal(o["reloaded"]["state"][k], v,
                                          err_msg=k)
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cpu")
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=list(model.named_parameters()))
    state = {**model.state_dict(keep_vars=True), **tck.optimizer_state(opt)}
    tck.load_state_dict(state, path)
    opt.set_state_dict(state)
    got = gather_jax_layout(model)
    for n, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(got[n], p, err_msg=n)
    sd = opt.state_dict()
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_zero_at_world_size_one_is_the_identity():
    """No axis of degree > 1: the model and optimizer come back as they
    were."""
    from paddle_tpu_torch.distributed import env as env_mod
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    env_mod.reset_env()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    opt = AdamW(parameters=model.parameters())
    got = group_sharded_parallel(model, opt, level="p_g_os")
    assert got[0] is model and got[1] is opt and opt._zero is None
