"""The port's pipeline parallelism held against the JAX package's on its
virtual CPU mesh.

The reference runs in this process: ``fleet.init`` with the config's
``dp x mp x pp`` and ``pipeline_configs``, then its ``PipelineLayer``
model (one SPMD program) through ``fleet.distributed_model``'s
``PipelineParallel``. The port runs one process per rank, spawned by
``paddle_tpu_torch.distributed.spawn`` on gloo and meeting through a
``file://`` store under the test's directory; each rank builds only its
stage. The children import neither ``jax`` nor ``paddle_tpu`` (they
assert it): the reference's canonical ``state_dict`` (numpy) and the
batch reach them as pickles, and their results come back the same way.

Configurations (``CONFIGS``): the tiny Llama (4 layers, 4 heads, hidden
64, vocab 128) under pp 2 GPipe with 2 microbatches, pp 2 1F1B with 4,
pp 2 with 2 virtual stages, pp 4, pp 2 x mp 2 and dp 2 x pp 2 (1F1B);
the tiny ERNIE pipe (dropout 0) on ``nlu`` and ``nlg`` at pp 2; and a
model whose first and last layers are one ``SharedLayerDesc`` at pp 2.
Under ZeRO (``ZERO``): the Llama pipe at pp 2 x sharding 2 under
``p_g_os`` (the stage's layers gather their slices around each
microbatch's forward) and at dp 2 x pp 2 under ``os_g`` (1F1B), and the
shared model at pp 2 x sharding 2 under ``os_g`` (its shared weight's
gradient summed over the two stages on the slice); the reference's
results are those of the same pipe without ZeRO (``SAME_REFERENCE``).
One b4 x s16 batch, its labels with ignored tokens in the first row
only (so the microbatches' and dp shards' counts differ). Held, each
against the reference: the loss of ``forward_backward_pipeline`` on
every rank, every gradient in the canonical layout (``TOL``), the
losses of 3 ``train_batch`` steps of ``AdamW`` with
``ClipGradByGlobalNorm(1.0)`` (``TOL``) and the parameters after them
(``PARAM_TOL``), and the ``eval_batch`` loss. Also: GPipe and 1F1B at
the same microbatch count give the same bits; the reference's pp-1
canonical ``state_dict`` loads at pp 1, 2 and 4 and gives the
reference's loss, and the pp-4 ranks' gathered state loads back into the
reference; the blocks-per-stage errors and ERNIE's pipe under mp 2 with
a vocab mp does not divide; the counters against their formula.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu_torch.distributed import spawn

B, S, V = 4, 16, 128
TOL = 1e-5
# as tests/test_torch_fleet_llama.py: Adam moves each weight by about
# lr * sign(g) at first, so a gradient near 0 whose sign the two
# packages' summation orders flip moves it ~2 lr apart
PARAM_TOL = 2e-3
STEPS = 3
H = 8  # the shared model's width
# name: (model, pp, mp, dp, virtual stages, accumulate_steps, schedule)
CONFIGS = {
    "gpipe": ("llama", 2, 1, 1, 1, 2, ""),
    "1f1b": ("llama", 2, 1, 1, 1, 4, "1F1B"),
    "v2": ("llama", 2, 1, 1, 2, 2, ""),
    "pp4": ("llama", 4, 1, 1, 1, 4, ""),
    "pp2_mp2": ("llama", 2, 2, 1, 1, 2, ""),
    "dp2_pp2": ("llama", 2, 1, 2, 1, 2, "1F1B"),
    "ernie_nlu": ("nlu", 2, 1, 1, 1, 2, ""),
    "ernie_nlg": ("nlg", 2, 1, 1, 1, 2, ""),
    "shared": ("shared", 2, 1, 1, 1, 2, ""),
    "pp2_sh2_p_g_os": ("llama", 2, 1, 1, 1, 2, ""),
    "pp2_dp2_os_g": ("llama", 2, 1, 2, 1, 2, "1F1B"),
    "shared_sh2_os_g": ("shared", 2, 1, 1, 1, 2, ""),
}
# ZeRO (group_sharded_parallel) under the pipe: name: (level, sharding
# degree); the batch is split over dp x sharding
ZERO = {"pp2_sh2_p_g_os": ("p_g_os", 2), "pp2_dp2_os_g": ("os_g", 1),
        "shared_sh2_os_g": ("os_g", 2)}
# ZeRO is a layout in the reference (GSPMD keeps the global meaning):
# these take the reference of the config with the same mesh but for it
SAME_REFERENCE = {"pp2_sh2_p_g_os": "gpipe", "pp2_dp2_os_g": "dp2_pp2",
                  "shared_sh2_os_g": "shared"}
# the port alone, each held bit for bit against a config above: GPipe at
# 1F1B's microbatch count; GPipe with every block recomputed; GPipe
# through a GradScaler (a power-of-two scale: unscaling is exact)
PORT_ONLY = {"gpipe_n4": ("llama", 2, 1, 1, 1, 4, ""),
             "gpipe_recompute": ("llama_recompute", 2, 1, 1, 1, 2, ""),
             "gpipe_scaler": ("llama", 2, 1, 1, 1, 2, "")}


def _batch(model="llama"):
    rng = np.random.RandomState(7)
    if model == "shared":
        return (rng.randn(B, H).astype(np.float32),
                rng.randn(B, H).astype(np.float32))
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    if model == "nlu":  # masked LM: 4 predicted tokens a row
        labels = np.where(rng.rand(B, S) < 0.25, labels, -100)
    labels[0, :5] = -100
    return ids, labels


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


class _Tied(nn.Module):
    """``x @ weight``, square: the shared model's first and last layer."""

    def __init__(self, h):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(h, h))

    def forward(self, x):
        return x @ self.weight


class _Block(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.fc = nn.Linear(h, h)
        # Paddle's [in, out] layout, as the reference's Linear keeps it
        self.fc.weight = nn.Parameter(torch.zeros(h, h))

    def forward(self, x):
        return torch.tanh(x @ self.fc.weight + self.fc.bias)


def _mse(out, labels):
    return ((out - labels) ** 2).mean()


class _BatchMse:
    """The mean squared error over the whole batch when its rows are
    split over the batch ranks (dp x sharding): each microbatch's sum
    over the batch's count (``PipelineParallel`` hands it in), its value
    summed over the ranks."""

    def token_count(self, labels):
        return torch.tensor(labels.numel())

    def __call__(self, out, labels, count):
        from paddle_tpu_torch.distributed import _comm
        from paddle_tpu_torch.distributed import env as env_mod

        part = ((out - labels) ** 2).sum() / count
        return _comm.reduce_from(
            part, env_mod.ensure_env().group(("dp", "sharding")))


def _port_model(name, spec, device="cpu"):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc,
    )
    from paddle_tpu_torch.models import (
        ErnieConfig, ErnieForPretrainingPipe, LlamaConfig,
        LlamaForCausalLMPipe,
    )

    model, _, _, _, v, _, _ = spec
    if model.startswith("llama"):
        return LlamaForCausalLMPipe(
            LlamaConfig.tiny(recompute=model == "llama_recompute"),
            device=device, num_virtual_pipeline_stages=v)
    if model == "shared":
        return PipelineLayer(
            [SharedLayerDesc("tied", _Tied, None, "weight", H)]
            + [LayerDesc(_Block, H) for _ in range(2)]
            + [SharedLayerDesc("tied", _Tied, None, "weight", H)],
            loss_fn=_BatchMse() if name in ZERO else _mse)
    return ErnieForPretrainingPipe(
        ErnieConfig.tiny(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0),
        model, device=device)


def _strategy(spec, sharding=1):
    from paddle_tpu_torch.distributed import fleet

    _, pp, mp, dp, _, acc, sched = spec
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    s.pipeline_configs = {"accumulate_steps": acc, "micro_batch_size": 1,
                          "schedule": sched}
    return s


def _zero_grads(model, opt):
    """Under ZeRO: each gradient as its global tensor (the plan's slices
    gathered over the axis and mp), the stages put together, as
    ``gather_jax_layout(model, grads=True)`` gives them without ZeRO."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import _comm

    plan, out = opt._zero, {}
    for n, p in model.named_parameters():
        for _, g in plan.params_grads([p]):
            out[n] = plan.full(p, g).numpy()
    stages = [None] * len(model.pp_group()[0])
    _comm.run(tdist.all_gather_object, None, model.pp_group(), stages, out)
    return {k: v for stage in stages for k, v in stage.items()}


def _run_config(root, name, spec):
    """One config on this rank: loss and gradients of one
    ``forward_backward_pipeline``, then the steps and ``eval_batch``."""
    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models import gather_jax_layout, load_jax_weights
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    scaler = GradScaler(init_loss_scaling=2.0 ** 10) \
        if name == "gpipe_scaler" else None
    level, sharding = ZERO.get(name, (None, 1))
    fleet.init(is_collective=True, strategy=_strategy(spec, sharding))
    hcg = fleet.get_hybrid_communicate_group()
    model = _port_model(name, spec)
    with open(f"{root}/{name}.weights.pkl", "rb") as f:
        load_jax_weights(model, pickle.load(f))
    net = fleet.distributed_model(model)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    if level is not None:
        _, opt, _ = group_sharded_parallel(net, opt, level=level)
    x, y = (torch.from_numpy(a) for a in _batch(spec[0]))
    r = hcg.get_data_parallel_rank() * sharding \
        + hcg.get_sharding_parallel_rank()
    b = B // (spec[3] * sharding)
    x, y = x[r * b:(r + 1) * b], y[r * b:(r + 1) * b]
    out = {"stage": hcg.get_stage_id(), "dp": r,
           "loss": float(net.forward_backward_pipeline((x, y)))}
    net._reduce_gradients(opt)
    out["grads"] = gather_jax_layout(model, grads=True) if level is None \
        else _zero_grads(model, opt)
    opt.clear_grad()
    out["steps"] = [float(net.train_batch((x, y), opt, scaler=scaler))
                    for _ in range(STEPS)]
    out["params"] = gather_jax_layout(model)
    out["eval"] = float(net.eval_batch((x, y)))
    out["counters"] = dict(model.counters)
    out["n_micro"] = net._n_micro()
    out["chunks"] = model.num_chunks
    out["own"] = sorted(model.state_dict())
    return out


def _checkpoint_move(root, pp):
    """The reference's pp-1 canonical state at pp ``pp``: its loss, and
    this layout's state gathered back."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gather_jax_layout

    spec = ("llama", pp, 1, 1, 1, pp, "")
    fleet.init(is_collective=True, strategy=_strategy(spec))
    model = _port_model("ckpt", spec)
    with open(f"{root}/ckpt.weights.pkl", "rb") as f:
        missing, unexpected = model.set_state_dict(pickle.load(f))
    net = fleet.distributed_model(model)
    x, y = (torch.from_numpy(a) for a in _batch())
    return {"missing": missing, "unexpected": unexpected,
            "eval": float(net.eval_batch((x, y))),
            "state": gather_jax_layout(model)}


def _errors():
    """The errors a pipe raises at pp 2 (and ERNIE's under mp 2, where
    mp does not divide its vocab)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (
        ErnieConfig, ErnieForPretrainingPipe, LlamaConfig,
        LlamaForCausalLMPipe,
    )

    errors = []
    fleet.init(strategy=_strategy(("llama", 2, 1, 1, 1, 2, "")))
    for layers, v in ((3, 1), (2, 2)):
        try:
            LlamaForCausalLMPipe(LlamaConfig.tiny(num_hidden_layers=layers),
                                 device="cpu", num_virtual_pipeline_stages=v)
        except ValueError as e:
            errors.append(str(e))
    fleet.init(strategy=_strategy(("llama", 1, 2, 1, 1, 1, "")))
    try:
        ErnieForPretrainingPipe(ErnieConfig.tiny(vocab_size=127), "nlg",
                                device="cpu")
    except ValueError as e:
        errors.append(str(e))
    return errors


def _pipeline_worker(root, names):
    """One rank: every config in ``names`` in turn, results pickled to
    ``root/{name}.{rank}.pkl``."""
    _child_setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    for name in names:
        if name.startswith("ckpt"):
            out = _checkpoint_move(root, int(name[len("ckpt"):]))
        elif name == "errors":
            out = _errors()
        else:
            out = _run_config(root, name,
                              CONFIGS.get(name) or PORT_ONLY[name])
        with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


# -- the reference ----------------------------------------------------------------


def _jax_model(spec):
    import paddle_tpu as pt
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc,
    )
    from paddle_tpu.models import ErnieConfig, LlamaConfig
    from paddle_tpu.models.ernie import ErnieForPretrainingPipe
    from paddle_tpu.models.llama import LlamaForCausalLMPipe

    model, _, _, _, v, _, _ = spec
    if model == "llama":
        return LlamaForCausalLMPipe(LlamaConfig.tiny(),
                                    num_virtual_pipeline_stages=v)
    if model == "shared":
        class Tied(jnn.Layer):
            def __init__(self, h):
                super().__init__()
                self.weight = self.create_parameter([h, h])

            def forward(self, x):
                return pt.matmul(x, self.weight)

        class Block(jnn.Layer):
            def __init__(self, h):
                super().__init__()
                self.fc = jnn.Linear(h, h)

            def forward(self, x):
                return pt.tanh(self.fc(x))

        return PipelineLayer(
            [SharedLayerDesc("tied", Tied, None, "weight", H)]
            + [LayerDesc(Block, H) for _ in range(2)]
            + [SharedLayerDesc("tied", Tied, None, "weight", H)],
            loss_fn=lambda out, lbl: ((out - lbl) ** 2).mean())
    return ErnieForPretrainingPipe(
        ErnieConfig.tiny(hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0), model)


def _canonical(jm, grads=False):
    """The reference pipe's parameters (or gradients) under canonical
    keys, as numpy."""
    def arr(p):
        t = p.grad if grads else p
        return None if t is None else np.asarray(t.numpy())

    if not getattr(jm, "_pipelined", False):
        out = {n: arr(p) for n, p in jm.named_parameters()}
        return {k: a for k, a in out.items() if a is not None}
    out = {}
    for prefix, sub in jm._canonical_prefix_items():
        for n, p in sub.named_parameters():
            out[f"{prefix}.{n}"] = arr(p)
    for sp, _, keys in jm._stacked_layout():
        a = arr(sp)
        for j, k in enumerate(keys):
            out[k] = None if a is None else a[j]
    return {k: a for k, a in out.items() if a is not None}


def _jax_fleet(spec):
    from paddle_tpu.distributed import fleet as jfleet

    _, pp, mp, dp, _, acc, sched = spec
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp}
    s.pipeline_configs = {"accumulate_steps": acc, "micro_batch_size": 1,
                          "schedule": sched}
    jfleet.init(is_collective=True, strategy=s)
    return jfleet


def _reference(spec):
    """The JAX package's results for ``spec``, and its canonical
    weights."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv

    jfleet = _jax_fleet(spec)
    try:
        pt.seed(11)
        jm = _jax_model(spec)
        weights = {k: np.asarray(t.numpy())
                   for k, t in jm.state_dict().items()}
        net = jfleet.distributed_model(jm)
        data = tuple(pt.to_tensor(a) for a in _batch(spec[0]))
        ref = {"loss": float(net.forward_backward_pipeline(data).numpy())}
        ref["grads"] = _canonical(jm, grads=True)
        jm.clear_gradients()
        opt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                 parameters=jm.parameters(),
                                 grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
        ref["steps"] = [float(net.train_batch(data, opt).numpy())
                        for _ in range(STEPS)]
        ref["params"] = _canonical(jm)
        ref["eval"] = float(net.eval_batch(data).numpy())
    finally:
        jenv.reset_env()
    return weights, ref


def _reference_pp1():
    """The reference Llama pipe at pp 1: its canonical state and loss."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv

    spec = ("llama", 1, 1, 1, 1, 1, "")
    _jax_fleet(spec)
    try:
        pt.seed(5)
        jm = _jax_model(spec)
        weights = {k: np.asarray(t.numpy())
                   for k, t in jm.state_dict().items()}
        ids, labels = (pt.to_tensor(a) for a in _batch())
        loss = float(jm.loss_fn(jm(ids), labels).numpy())
    finally:
        jenv.reset_env()
    return weights, loss


def _reference_loss_of(state):
    """The reference pp-1 pipe's loss with ``state`` loaded."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv

    _jax_fleet(("llama", 1, 1, 1, 1, 1, ""))
    try:
        jm = _jax_model(("llama", 1, 1, 1, 1, 1, ""))
        missing, unexpected = jm.set_state_dict(state)
        assert not missing and not unexpected, (missing, unexpected)
        ids, labels = (pt.to_tensor(a) for a in _batch())
        return float(jm.loss_fn(jm(ids), labels).numpy())
    finally:
        jenv.reset_env()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference, [each rank's results])} and the checkpoint
    moves; the ranks of each world size spawned once."""
    root = tmp_path_factory.mktemp("pipeline")
    refs, weights = {}, {}
    for name, spec in CONFIGS.items():
        if name not in SAME_REFERENCE:
            weights[name], refs[name] = _reference(spec)
    for name, same in SAME_REFERENCE.items():
        weights[name], refs[name] = weights[same], refs[same]
    weights["gpipe_n4"] = weights["1f1b"]
    weights["gpipe_recompute"] = weights["gpipe_scaler"] = weights["gpipe"]
    weights["ckpt"], refs["ckpt"] = _reference_pp1()
    out = {"ckpt_ref": (weights["ckpt"], refs["ckpt"])}
    worlds = {2: ["gpipe", *PORT_ONLY, "1f1b", "v2", "ernie_nlu",
                  "ernie_nlg", "shared", "ckpt2", "errors"],
              4: ["pp4", "pp2_mp2", "dp2_pp2", "ckpt4", *ZERO]}
    for world, names in worlds.items():
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name, w in weights.items():
            with open(sub / f"{name}.weights.pkl", "wb") as f:
                pickle.dump(w, f)
        spawn(_pipeline_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            out[name] = (refs.get(name), ranks)
    return out


def _close(got, want, name, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_matches_reference_on_every_rank(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["loss"] - ref["loss"]) <= TOL, (o["loss"], ref["loss"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_gradient_matches_reference(runs, name):
    """Every gradient, gathered into the canonical layout; a parameter
    the model never reads (ERNIE's token-type table) has none in the
    port and zeros in the reference."""
    ref, ranks = runs[name]
    for o in ranks:
        for n, g in ref["grads"].items():
            if n not in o["grads"]:
                assert not np.any(g), n
                continue
            _close(o["grads"][n], g, n)
        assert set(o["grads"]) <= set(ref["grads"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_batch_steps_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_batch_matches_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["eval"] - ref["eval"]) <= TOL, (o["eval"], ref["eval"])


@pytest.mark.parametrize("name,same", [("gpipe_n4", "1f1b"),
                                       ("gpipe_recompute", "gpipe"),
                                       ("gpipe_scaler", "gpipe")])
def test_schedules_recompute_and_scaler_give_the_same_bits(runs, name,
                                                           same):
    """At one microbatch count GPipe and 1F1B accumulate the same
    microbatches' gradients in the same order; recomputing each block
    replays its forward's ops; a power-of-two loss scale unscales
    exactly, and the stages agree that no gradient overflowed."""
    _, gpipe = runs[name]
    _, one_f = runs[same]
    for a, b in zip(gpipe, one_f):
        assert a["loss"] == b["loss"] and a["steps"] == b["steps"]
        assert a["eval"] == b["eval"]
        for n in a["grads"]:
            np.testing.assert_array_equal(a["grads"][n], b["grads"][n])
        for n in a["params"]:
            np.testing.assert_array_equal(a["params"][n], b["params"][n])


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_canonical_checkpoint_moves_between_layouts(runs, pp):
    """The reference's pp-1 state loads at pp 1, 2 and 4 and gives its
    loss; pp 4's gathered state loads back into the reference."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLMPipe

    weights, want = runs["ckpt_ref"]
    if pp == 1:
        model = LlamaForCausalLMPipe(LlamaConfig.tiny(), device="cpu")
        assert model.set_state_dict(weights) == ([], [])
        ids, labels = (torch.from_numpy(a) for a in _batch())
        assert abs(float(model.loss_fn(model(ids), labels)) - want) <= TOL
        return
    _, ranks = runs[f"ckpt{pp}"]
    for o in ranks:
        assert o["missing"] == [] and o["unexpected"] == []
        assert abs(o["eval"] - want) <= TOL, (o["eval"], want)
        assert sorted(o["state"]) == sorted(weights)
    if pp == 4:
        assert abs(_reference_loss_of(ranks[0]["state"]) - want) <= TOL


def test_layouts_place_the_blocks_as_the_reference_stores_them(runs):
    """Stage d holds chunk c of blocks ``[(c * pp + d) * bpc, +bpc)``;
    stage 0 the embedding, the last stage the norm and head."""
    for name in ("gpipe", "v2", "pp4"):
        _, ranks = runs[name]
        pp, v = CONFIGS[name][1], CONFIGS[name][4]
        bpc = 4 // (pp * v)
        for o in ranks:
            d = o["stage"]
            want = {1 + (c * pp + d) * bpc + i for c in range(v)
                    for i in range(bpc)}
            if d == 0:
                want.add(0)
            if d == pp - 1:
                want.add(5)
            assert o["chunks"] == v
            assert {int(k.split(".")[0]) for k in o["own"]} == want


@pytest.mark.parametrize("name", ["gpipe", "1f1b", "v2", "pp4"])
def test_counters_match_their_formula(runs, name):
    """One ``forward_backward_pipeline``, 3 ``train_batch`` and one
    ``eval_batch``: 5 forwards of ``n`` microbatches; stage ``d`` sends
    an activation for each forward of a chunk but the last virtual
    stage, and an input gradient for each backward but the first's, each
    ``b/n x s x hidden`` fp32."""
    _, ranks = runs[name]
    pp, v = CONFIGS[name][1], CONFIGS[name][4]
    for o in ranks:
        n, d = o["n_micro"], o["stage"]
        sends = 5 * n * (v - (d == pp - 1)) + 4 * n * (v - (d == 0))
        assert o["counters"] == {
            "forwards": 5, "microbatches": 5 * n, "sends": sends,
            "bytes_sent": sends * (B // n) * S * 64 * 4}, o["counters"]


def test_errors(runs):
    _, ranks = runs["errors"]
    for errors in ranks:
        assert len(errors) == 3, errors
        assert "pipeline blocks (3) must divide evenly over pp stages (2) " \
            "x virtual stages (1)" in errors[0]
        assert "pipeline blocks (2)" in errors[1] and "(2)" in errors[1]
        assert "vocab_size = 127" in errors[2] and "mp = 2" in errors[2] \
            and "reference raises too" in errors[2]


def test_distributed_model_returns_the_pipeline_under_pp(runs):
    """The steps ran through ``fleet.distributed_model``'s
    ``PipelineParallel`` (its ``_n_micro`` is max(accumulate_steps,
    pp))."""
    for name, spec in CONFIGS.items():
        _, ranks = runs[name]
        assert {o["n_micro"] for o in ranks} == {max(spec[5], spec[1])}
