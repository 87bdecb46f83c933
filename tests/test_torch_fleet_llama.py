"""The port's tensor- and sequence-parallel Llama held against the JAX
package's on its virtual CPU mesh.

The reference runs in this process (``fleet.init`` over the first
``dp x mp`` of its 8 devices). The port runs one process per rank,
spawned by ``paddle_tpu_torch.distributed.spawn``, on gloo, meeting
through a ``file://`` store under ``tmp_path``; each rank thread-bound
to one core. The children import neither ``jax`` nor ``paddle_tpu``
(they assert it): the inputs and the reference's global weights reach
them as numpy files, and their results come back the same way.

The tiny Llama (2 layers, 4 heads, hidden 64, vocab 128) from the
reference's weights, on one b4 x s16 batch whose labels hold 5 ignored
tokens in the first two rows only (so the dp shards' counts differ),
under:

- ``mp2``: mp 2, 2 kv heads (nh != nkv: each rank's q, k and v heads
  are re-laid from the fused weight; a wrong permutation shows);
- ``mp2_sp``: the same with ``sequence_parallel=True``;
- ``mp2_gqa``: mp 2 with 1 kv head (nkv % mp != 0: K and V replicated,
  repeated per q head);
- ``dp2``: dp 2 through ``DataParallel``;
- ``dp2_mp2``: dp 2 x mp 2, four ranks.

Held, each against the reference within ``TOL``: the logits (the
ranks' shards put together by batch and vocab), the loss on every rank,
every gradient (through ``gather_jax_layout``), and the losses of 3
``AdamW`` steps with ``ClipGradByGlobalNorm(1.0)`` through
``fleet.distributed_model``/``distributed_optimizer`` and ``TrainStep``,
and the parameters after them (within ``PARAM_TOL``, see there); under
``mp2`` and ``mp2_gqa`` also 2 ``Lamb`` steps with ``ClipGradByNorm``.
Also: the uneven splits raise naming the dim and the degree, and
``LBFGS`` refuses more than one rank.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

B, S, V = 4, 16, 128
TOL = 1e-5
# parameters after the steps: Adam moves each weight by about lr * sign(g)
# at first, so a gradient near 0 whose sign the two packages' summation
# orders flip moves it ~2 lr apart (tests/test_torch_train.py holds its
# AdamW run to the same); the losses of the steps are held to TOL
PARAM_TOL = 2e-3
STEPS = 3
LAMB = ("mp2", "mp2_gqa")  # also 2 Lamb steps with ClipGradByNorm(0.05)
CONFIGS = {  # name: (dp, mp, num_key_value_heads, sequence_parallel)
    "mp2": (1, 2, 2, False),
    "mp2_sp": (1, 2, 2, True),
    "mp2_gqa": (1, 2, 1, False),
    "dp2": (2, 1, 2, False),
    "dp2_mp2": (2, 2, 2, False),
}


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 4:6] = -100  # the first dp shard: 5 ignored, the second 0
    return ids, labels


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _llama_worker(root, names):
    """One rank: every config in ``names`` in turn, results pickled to
    ``root/{name}.{rank}.pkl``."""
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, gather_jax_layout, load_jax_weights,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
    from paddle_tpu_torch.optimizer import AdamW, Lamb

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    ids, labels = (torch.from_numpy(a) for a in _batch())
    for name in names:
        dp, mp, nkv, sp = CONFIGS[name]
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        with open(f"{root}/{name}.weights.pkl", "rb") as f:
            weights = pickle.load(f)
        cfg = LlamaConfig.tiny(num_hidden_layers=2, num_key_value_heads=nkv,
                               sequence_parallel=sp)
        model = LlamaForCausalLM(cfg, device="cpu")
        load_jax_weights(model, weights)
        r, b = hcg.get_data_parallel_rank(), B // dp
        mine = slice(r * b, (r + 1) * b)
        x, y = ids[mine], labels[mine]
        out = {"coords": (r, hcg.get_model_parallel_rank()),
               "sp_layer": type(model.llama.layers[0].self_attn.qkv_proj)
               .__name__}
        net = fleet.distributed_model(model)
        with torch.no_grad():
            out["logits"] = net(x).numpy()
        loss = net(x, y)
        loss.backward()
        out["loss"] = float(loss)
        out["grads"] = gather_jax_layout(model, grads=True)
        model.zero_grad(set_to_none=True)
        opt = fleet.distributed_optimizer(AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=model.parameters(),
            grad_clip=ClipGradByGlobalNorm(1.0)))
        step = TrainStep(net, opt, lambda m, i, l: m(i, l))
        out["steps"] = [float(step(x, y)) for _ in range(STEPS)]
        out["params"] = gather_jax_layout(model)
        if name in LAMB:
            # Lamb's trust ratio and ClipGradByNorm: norms of sharded
            # parameters
            load_jax_weights(model, weights)
            opt = Lamb(learning_rate=1e-3, parameters=model.parameters(),
                       grad_clip=ClipGradByNorm(0.05))
            out["lamb"] = [float(TrainStep(net, opt)(x, y))
                           for _ in range(2)]
            out["lamb_params"] = gather_jax_layout(model)
        with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def _reference(name):
    """The JAX package's results for ``name`` on its mesh, and the global
    weights the ranks load."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama

    dp, mp, nkv, sp = CONFIGS[name]
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        cfg = JaxConfig.tiny(num_hidden_layers=2, num_key_value_heads=nkv,
                             sequence_parallel=sp)
        pt.seed(11)
        jm = JaxLlama(cfg)
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        ids, labels = (pt.to_tensor(a) for a in _batch())
        ref = {"logits": np.asarray(jm(ids).numpy())}
        loss = jm(ids, labels)
        loss.backward()
        ref["loss"] = float(loss.numpy())
        ref["grads"] = {n: np.asarray(p.grad.numpy())
                        for n, p in jm.named_parameters()}
        jm.clear_gradients()
        net = jfleet.distributed_model(jm)
        opt = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=jm.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
        steps = []
        for _ in range(STEPS):
            loss = net(ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            steps.append(float(loss.numpy()))
        ref["steps"] = steps
        ref["params"] = {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()}
        if name in LAMB:
            pt.seed(11)  # the same weights again
            jm = JaxLlama(cfg)
            net = jfleet.distributed_model(jm)
            opt = pt.optimizer.Lamb(learning_rate=1e-3,
                                    parameters=jm.parameters(),
                                    grad_clip=pt.nn.ClipGradByNorm(0.05))
            lamb = []
            for _ in range(2):
                loss = net(ids, labels)
                loss.backward()
                opt.step()
                opt.clear_grad()
                lamb.append(float(loss.numpy()))
            ref["lamb"] = lamb
            ref["lamb_params"] = {n: np.asarray(p._data)
                                  for n, p in jm.named_parameters()}
    finally:
        jenv.reset_env()
    return weights, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference, [each rank's results])}: the ranks of the two
    world sizes spawned once each."""
    root = tmp_path_factory.mktemp("fleet_llama")
    refs = {}
    for name in CONFIGS:
        weights, refs[name] = _reference(name)
        with open(root / f"{name}.weights.pkl", "wb") as f:
            pickle.dump(weights, f)
    by_world: dict = {}
    for name, (dp, mp, _, _) in CONFIGS.items():
        by_world.setdefault(dp * mp, []).append(name)
    for world, names in sorted(by_world.items()):
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name in names:
            os.link(root / f"{name}.weights.pkl",
                    sub / f"{name}.weights.pkl")
        spawn(_llama_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            refs[name] = (refs[name], ranks)
    return refs


def _close(got, want, name, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_match_reference(runs, name):
    ref, ranks = runs[name]
    dp, mp, _, _ = CONFIGS[name]
    rows = []
    for r in range(dp):
        shards = sorted((o["coords"][1], o["logits"]) for o in ranks
                        if o["coords"][0] == r)
        rows.append(np.concatenate([s for _, s in shards], axis=-1))
    _close(np.concatenate(rows, axis=0), ref["logits"], "logits")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_matches_reference_on_every_rank(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["loss"] - ref["loss"]) <= TOL, (o["loss"], ref["loss"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_gradient_matches_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert o["grads"].keys() == ref["grads"].keys()
        for n, g in o["grads"].items():
            _close(g, ref["grads"][n], n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_adamw_steps_with_global_clip_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("name", LAMB)
def test_lamb_and_per_parameter_clip_match_reference(runs, name):
    """Lamb's trust ratio and ``ClipGradByNorm`` take each sharded
    parameter's global norm (K and V replicated in ``mp2_gqa``)."""
    ref, ranks = runs[name]
    for o in ranks:
        np.testing.assert_allclose(o["lamb"], ref["lamb"], atol=TOL, rtol=0)
        for n, p in o["lamb_params"].items():
            np.testing.assert_allclose(p, ref["lamb_params"][n],
                                       atol=PARAM_TOL, rtol=0, err_msg=n)


def test_layers_are_the_sequence_parallel_ones_under_sp(runs):
    assert {o["sp_layer"] for o in runs["mp2_sp"][1]} == {
        "ColumnSequenceParallelLinear"}
    assert {o["sp_layer"] for o in runs["mp2"][1]} == {
        "ColumnParallelLinear"}


def _uneven_worker(root):
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    dist.init_parallel_env(mp=2, backend="gloo",
                           init_method=f"file://{root}/store")
    fleet.init(strategy=_strategy(mp=2))
    errors = []
    for kw in ({"vocab_size": 127}, {"intermediate_size": 129}):
        try:
            LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1, **kw),
                             device="cpu")
        except ValueError as e:
            errors.append(str(e))
    model = LlamaForCausalLM(LlamaConfig.tiny(
        num_hidden_layers=1, sequence_parallel=True), device="cpu")
    try:
        model(torch.zeros((1, 15), dtype=torch.int64))
    except ValueError as e:
        errors.append(str(e))
    from paddle_tpu_torch.optimizer import LBFGS

    try:
        fleet.distributed_optimizer(LBFGS(parameters=model.parameters()))
    except NotImplementedError as e:
        errors.append(str(e))
    with open(f"{root}/errors.{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(errors, f)
    dist.destroy_process_group()


def _strategy(**degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return s


def test_uneven_splits_and_lbfgs_over_ranks_raise(tmp_path):
    spawn(_uneven_worker, args=(str(tmp_path),), nprocs=2)
    for r in range(2):
        with open(tmp_path / f"errors.{r}.pkl", "rb") as f:
            errors = pickle.load(f)
        assert len(errors) == 4, errors
        assert "vocab_size = 127" in errors[0] and "mp = 2" in errors[0]
        assert "intermediate_size = 129" in errors[1]
        assert "sequence length 15" in errors[2] and "mp = 2" in errors[2]
        assert "LBFGS over more than one rank" in errors[3]


# -- decode at mp 2 -------------------------------------------------------------

GEN_NEW = 4


def _gen_ids():
    return np.random.RandomState(17).randint(0, V, (2, 8)).astype(np.int32)


def _generate_worker(root):
    """One rank at mp 2: greedy ``generate()`` and the serving engine on
    the two rows as two requests, tokens pickled."""
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, generate, load_jax_weights,
    )
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    fleet.init(is_collective=True, strategy=_strategy(mp=2))
    with open(f"{root}/weights.pkl", "rb") as f:
        weights = pickle.load(f)
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                             device="cpu")
    load_jax_weights(model, weights)
    ids = _gen_ids()
    out = {"generate": generate(model, ids, max_new_tokens=GEN_NEW,
                                device="cpu").numpy()}
    eng = ServingEngine(model, ServingConfig(max_seq_len=32), device="cpu")
    reqs = [eng.submit(row, max_new_tokens=GEN_NEW) for row in ids]
    done = eng.run()
    out["engine"] = np.stack([np.asarray(done[r.request_id]) for r in reqs])
    with torch.no_grad():  # a shard written in place rebuilds the weights
        model.lm_head.weight.mul_(-1)
    out["flipped"] = generate(model, ids, max_new_tokens=GEN_NEW,
                              device="cpu").numpy()
    with open(f"{root}/gen.{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def test_generate_and_engine_at_mp2_match_reference(tmp_path):
    """The reference decodes the tiny Llama at mp 2 on its mesh; the
    port's two ranks decode the same weights through ``generate()`` and
    ``ServingEngine`` (each rank the whole model, its weights gathered)
    and give the reference's tokens, and again after ``lm_head``'s
    shards are written in place."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import generate as jax_generate

    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        pt.seed(11)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2))
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        ids = pt.to_tensor(_gen_ids())
        want = jax_generate(jm, ids, max_new_tokens=GEN_NEW).numpy()
        jm.lm_head.weight.set_value(-jm.lm_head.weight)
        flipped = jax_generate(jm, ids, max_new_tokens=GEN_NEW).numpy()
    finally:
        jenv.reset_env()
    with open(tmp_path / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    spawn(_generate_worker, args=(str(tmp_path),), nprocs=2)
    assert not np.array_equal(want, flipped)
    for r in range(2):
        with open(tmp_path / f"gen.{r}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["generate"].shape == (2, GEN_NEW)
        np.testing.assert_array_equal(got["generate"], want, err_msg=f"{r}")
        np.testing.assert_array_equal(got["engine"], want, err_msg=f"{r}")
        np.testing.assert_array_equal(got["flipped"], flipped,
                                      err_msg=f"{r}")
