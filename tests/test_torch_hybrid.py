"""The reference's hybrid step held against the JAX package on its
virtual CPU mesh: the Llama pipe under sequence and context parallelism,
and the experts under both.

The reference runs in this process (``fleet.init`` on its 8 virtual
devices, ``sep_degree`` included), on its global arrays; the port runs
one process per rank, spawned by ``paddle_tpu_torch.distributed.spawn``
on gloo through a ``file://`` store under the test's directory, one
thread each. The children import neither ``jax`` nor ``paddle_tpu``
(asserted); weights, batches and results cross as pickled numpy. A dp
rank takes its rows of the batch (under the pipe its chunk of each
microbatch, as the reference's GSPMD splits a microbatch); under
context parallelism a rank takes its sequence chunk of them (chunks in
sep order); under SP each mp rank takes the whole sequence, which the
embedding scatters.

Configurations, the tiny Llama (hidden 64, 4 heads, vocab 128) on one b4
x s16 batch whose ignored labels fall unevenly over the rows and the
sequence chunks:

- ``hybrid``: the reference's dry-run layout (``__graft_entry__.py``'s
  ``dryrun_multichip``): ``LlamaForCausalLMPipe`` at dp 2 x mp 2 x pp 2,
  ``sequence_parallel=True``, 4 experts over dp (top-2), the parallel
  CE, 1F1B with 2 microbatches, 8 ranks;
- ``pp2_mp2_sp``: the pipe with SP at pp 2 x mp 2;
- ``pp2_sep2_ring``: the pipe with ring attention at pp 2 x sep 2, with
  4 experts (dp 1: all experts on every rank, the gate global over sep);
- ``pp2_sep2_ulysses``: the pipe with Ulysses at pp 2 x sep 2;
- ``moe_mp2_sp``, ``moe_dp2_mp2_sp``: the MoE ``LlamaForCausalLM`` under
  SP at mp 2 and dp 2 x mp 2 (the aux loss included);
- ``moe_sep2``, ``moe_dp2_sep2``: the MoE ``LlamaForCausalLM`` with ring
  context parallelism at sep 2 and dp 2 x sep 2;
- ``mp2_sep2_sp_ring``, ``mp2_sep2_sp_ulysses``: ``LlamaForCausalLM``
  with SP and context parallelism together at mp 2 x sep 2 (a rank's
  sequence chunk split further over mp), ring and Ulysses;
- ``moe_mp2_sep2_sp``: the MoE Llama the same way, the gate counting
  over the sequence split ``(sep, mp)``;
- ``pp2_mp2_sep2_sp``: the pipe with SP and ring at pp 2 x mp 2 x sep 2
  (8 ranks);
- ``hybrid_os_g``: ``hybrid`` under ZeRO ``os_g`` over dp
  (``group_sharded_parallel``): the experts stay over dp, every other
  parameter's states gain a dp cut beside its mp cut (the reference's
  result is ``hybrid``'s: ZeRO is a layout there);
- the experts over the sequence axes (``AXIS``): ``moe_sep2_axis_sep``
  (over sep under ring context parallelism: the buffer reduce-scattered
  over sep), ``moe_mp2_sp_axis_mp`` (over mp under SP) and
  ``moe_mp2_sep2_sp_axis_sep_mp`` (over ``("sep", "mp")`` under both);
- a sequence of 15 that mp 2 does not divide under SP (``SEQ``): the
  pipe ``pp2_mp2_sp_s15`` and the MoE Llama ``moe_mp2_sp_s15``, whose
  padding row never reaches the gate (its dispatched set is the
  reference's, which has no padding); and ``moe_mp2_sep2_sp_s14``, a
  sequence of 14 under SP and ring at mp 2 x sep 2, each sep chunk of 7
  padded to 8, the experts over ``("sep", "mp")``.

Held, each against the reference within ``TOL``: the loss on every rank,
every gradient (``gather_jax_layout``; canonical keys for the pipes),
the losses of 2 ``AdamW`` steps with ``ClipGradByGlobalNorm(1.0)`` and
the parameters after them (``PARAM_TOL``). For the MoE models also the
first layer's dispatched (token, expert, slot) set, global over the
ranks; for the pipes the bytes ``PipelineLayer.counters`` counts
(``[mb, s / mp, h]``, ``[mb, s / sep, h]`` or under both ``[mb, s /
(sep mp), h]`` a boundary, ``s`` padded to a multiple of mp). And the
combinations that still raise, and those that no longer do.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

B, S, V, H = 4, 16, 128, 64
TOL = 1e-5
# as tests/test_torch_fleet_llama.py: Adam moves each weight by about
# lr * sign(g) at first, so a gradient near 0 whose sign the two
# packages' summation orders flip moves it ~2 lr apart
PARAM_TOL = 2e-3
STEPS = 2
N_MICRO = 2
# name: (dp, mp, pp, sep, sequence_parallel, context mode, experts)
CONFIGS = {
    "hybrid": (2, 2, 2, 1, True, None, 4),
    "pp2_mp2_sp": (1, 2, 2, 1, True, None, 0),
    "pp2_sep2_ring": (1, 1, 2, 2, False, "ring", 4),
    "pp2_sep2_ulysses": (1, 1, 2, 2, False, "ulysses", 0),
    "moe_mp2_sp": (1, 2, 1, 1, True, None, 4),
    "moe_dp2_mp2_sp": (2, 2, 1, 1, True, None, 4),
    "moe_sep2": (1, 1, 1, 2, False, "ring", 4),
    "moe_dp2_sep2": (2, 1, 1, 2, False, "ring", 4),
    "mp2_sep2_sp_ring": (1, 2, 1, 2, True, "ring", 0),
    "mp2_sep2_sp_ulysses": (1, 2, 1, 2, True, "ulysses", 0),
    "moe_mp2_sep2_sp": (1, 2, 1, 2, True, "ring", 4),
    "pp2_mp2_sep2_sp": (1, 2, 2, 2, True, "ring", 0),
    "hybrid_os_g": (2, 2, 2, 1, True, None, 4),
    "moe_sep2_axis_sep": (1, 1, 1, 2, False, "ring", 4),
    "moe_mp2_sp_axis_mp": (1, 2, 1, 1, True, None, 4),
    "moe_mp2_sep2_sp_axis_sep_mp": (1, 2, 1, 2, True, "ring", 4),
    "pp2_mp2_sp_s15": (1, 2, 2, 1, True, None, 0),
    "moe_mp2_sp_s15": (1, 2, 1, 1, True, None, 4),
    "moe_mp2_sep2_sp_s14": (1, 2, 1, 2, True, "ring", 4),
}
# the experts' axes where not dp
AXIS = {"moe_sep2_axis_sep": "sep", "moe_mp2_sp_axis_mp": "mp",
        "moe_mp2_sep2_sp_axis_sep_mp": ("sep", "mp"),
        "moe_mp2_sep2_sp_s14": ("sep", "mp")}
# the sequence length where not S
SEQ = {"pp2_mp2_sp_s15": 15, "moe_mp2_sp_s15": 15, "moe_mp2_sep2_sp_s14": 14}
# the layout the reference runs where not the config's own (its result
# does not depend on it, see SAME_REFERENCE; one device compiles fastest)
REF_SPEC = {"moe_mp2_sep2_sp_s14": (1, 1, 1, 1, False, None, 4)}
# ZeRO under the pipe: name: its level (over dp, sharding being 1)
ZERO = {"hybrid_os_g": "os_g"}
# the reference's result does not depend on its layout (GSPMD keeps the
# global meaning), nor on which exact attention it runs: these take the
# reference of the named config (its compiles are the file's largest
# cost: the reference's Ulysses at mp 2 x sep 2 and its pipe at pp 2 x
# mp 2 x sep 2 take ~50 s each here)
SAME_REFERENCE = {"moe_mp2_sp": "moe_dp2_mp2_sp", "moe_sep2": "moe_dp2_sep2",
                  "moe_mp2_sep2_sp": "moe_dp2_mp2_sp",
                  "mp2_sep2_sp_ulysses": "mp2_sep2_sp_ring",
                  "pp2_mp2_sep2_sp": "pp2_mp2_sp", "hybrid_os_g": "hybrid",
                  "moe_sep2_axis_sep": "moe_dp2_sep2",
                  "moe_mp2_sp_axis_mp": "moe_dp2_mp2_sp",
                  "moe_mp2_sep2_sp_axis_sep_mp": "moe_dp2_mp2_sp"}
WORLDS = {2: ["moe_mp2_sp", "moe_sep2", "moe_sep2_axis_sep",
              "moe_mp2_sp_axis_mp", "moe_mp2_sp_s15"],
          4: ["pp2_mp2_sp", "pp2_sep2_ring", "pp2_sep2_ulysses",
              "moe_dp2_mp2_sp", "moe_dp2_sep2", "mp2_sep2_sp_ring",
              "mp2_sep2_sp_ulysses", "moe_mp2_sep2_sp",
              "moe_mp2_sep2_sp_axis_sep_mp", "pp2_mp2_sp_s15",
              "moe_mp2_sep2_sp_s14", "errors"],
          8: ["hybrid", "pp2_mp2_sep2_sp", "hybrid_os_g"]}


def _batch(seq=S):
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 9:12] = -100  # the rows' and the chunks' counts differ
    return ids[:, :seq], labels[:, :seq]


def _config(module, spec, **kw):
    _, _, pp, _, sp, mode, experts = spec
    return module.LlamaConfig.tiny(
        num_hidden_layers=2 * pp, num_key_value_heads=2,
        sequence_parallel=sp, context_parallel=mode is not None,
        context_parallel_mode=mode or "ring", moe_num_experts=experts,
        use_parallel_cross_entropy=True, **kw)


def _padded(seq, spec):
    """The sequence as SP scatters it: padded to a multiple of mp."""
    mp = spec[1] if spec[4] else 1
    return -(-seq // mp) * mp


def _close(got, want, name, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=tol, rtol=0,
                               err_msg=name)


# -- the reference ----------------------------------------------------------------


def _jax_fleet(spec):
    from paddle_tpu.distributed import fleet as jfleet

    dp, mp, pp, sep = spec[:4]
    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sep_degree": sep}
    if pp > 1:
        s.pipeline_configs = {"accumulate_steps": N_MICRO,
                              "micro_batch_size": 1, "schedule": "1F1B"}
    jfleet.init(is_collective=True, strategy=s)
    return jfleet


def _canonical(jm, grads=False):
    """The reference pipe's parameters (or gradients) under canonical
    keys, as numpy (its stacked blocks split per layer)."""
    def arr(p):
        t = p.grad if grads else p
        return None if t is None else np.asarray(t.numpy())

    out = {}
    for prefix, sub in jm._canonical_prefix_items():
        for n, p in sub.named_parameters():
            out[f"{prefix}.{n}"] = arr(p)
    for sp, _, keys in jm._stacked_layout():
        a = arr(sp)
        for j, k in enumerate(keys):
            out[k] = None if a is None else a[j]
    return {k: a for k, a in out.items() if a is not None}


def _jax_dispatched(jm, ids, cap):
    """The first MoE layer's dispatched (token, expert, slot) set: its
    input recorded in a forward, its gate's dispatch."""
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml

    seen, forward = [], jml.MoELayer.forward

    def recording(layer, x):
        if not seen:
            seen.append((layer, np.asarray(x.numpy())))
        return forward(layer, x)

    jml.MoELayer.forward = recording
    try:
        with pt.no_grad():
            jm(pt.to_tensor(ids))
    finally:
        jml.MoELayer.forward = forward
    layer, x = seen[0]
    logits = jnp.asarray(x.reshape(-1, x.shape[-1])) \
        @ jnp.asarray(layer.gate_weight.numpy())
    dispatch = np.asarray(jml._top2_gating(logits, cap)[1])
    return {tuple(int(i) for i in ix) for ix in np.argwhere(dispatch > 0)}


def _reference(name):
    """The reference's weights (canonical for a pipe) and results."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.incubate.distributed.models.moe.moe_layer import (
        MoELayer as JM,
    )
    from paddle_tpu.models import llama as jllama

    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
        capacity,
    )

    spec = REF_SPEC.get(name, CONFIGS[name])
    seq = SEQ.get(name, S)
    jfleet = _jax_fleet(spec)
    try:
        pt.seed(11)
        cfg = _config(jllama, spec)
        data = tuple(pt.to_tensor(a) for a in _batch(seq))
        clip = pt.nn.ClipGradByGlobalNorm(1.0)
        if spec[2] > 1:
            jm = jllama.LlamaForCausalLMPipe(cfg)
            weights = {k: np.asarray(t.numpy())
                       for k, t in jm.state_dict().items()}
            net = jfleet.distributed_model(jm)
            ref = {"loss": float(net.forward_backward_pipeline(data)
                                 .numpy()),
                   "grads": _canonical(jm, grads=True)}
            jm.clear_gradients()
            opt = pt.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                     parameters=jm.parameters(),
                                     grad_clip=clip)
            ref["steps"] = [float(net.train_batch(data, opt).numpy())
                            for _ in range(STEPS)]
            ref["params"] = _canonical(jm)
            return weights, ref
        jm = jllama.LlamaForCausalLM(cfg)
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        ref = {}
        if spec[6]:
            cap = capacity(2, B * seq, spec[6], 1.25)
            assert jm.llama.layers[0].mlp.capacity_factor == 1.25
            assert isinstance(jm.llama.layers[0].mlp, JM)
            ref["dispatched"] = _jax_dispatched(jm, _batch(seq)[0], cap)
        loss = jm(*data)
        loss.backward()
        ref["loss"] = float(loss.numpy())
        ref["grads"] = {n: np.asarray(p.grad.numpy())
                        for n, p in jm.named_parameters()}
        jm.clear_gradients()
        net = jfleet.distributed_model(jm)
        opt = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=jm.parameters(), grad_clip=clip))
        steps = []
        for _ in range(STEPS):
            loss = net(*data)
            loss.backward()
            opt.step()
            opt.clear_grad()
            steps.append(float(loss.numpy()))
        ref["steps"] = steps
        ref["params"] = {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()}
    finally:
        jenv.reset_env()
    return weights, ref


# -- the port's ranks -------------------------------------------------------------


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _strategy(dp=1, mp=1, pp=1, sep=1, sharding=1):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sep_degree": sep, "sharding_degree": sharding}
    s.pipeline_configs = {"accumulate_steps": N_MICRO, "micro_batch_size": 1,
                          "schedule": "1F1B"}
    return s


def _rank_inputs(spec, hcg, seq=S):
    """This rank's ids and labels: its dp rows (under the pipe its chunk
    of each microbatch) and, under context parallelism, its sequence
    chunk of them."""
    dp, _, pp, sep = spec[:4]
    rows = np.arange(B)
    r = hcg.get_data_parallel_rank()
    rows = (rows.reshape(N_MICRO, dp, -1)[:, r] if pp > 1
            else rows.reshape(dp, -1)[r]).reshape(-1)
    cols = np.arange(seq)
    if spec[5] is not None:
        cols = cols.reshape(sep, -1)[hcg.get_sep_parallel_rank()]
    return ([torch.from_numpy(a[rows][:, cols]) for a in _batch(seq)], rows,
            cols)


def _dispatched(model, x, spec, rows, cols, mp_rank, seq=S):
    """The first MoE layer's dispatched set from this rank's tokens, by
    their global (row * seq + column) indices; under SP a padded column
    (past ``seq``) is no token."""
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
        capacity,
    )

    seen = []
    mlp = model.llama.layers[0].mlp
    handle = mlp.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]) if not seen else None)
    with torch.no_grad():
        model(x)
        handle.remove()
        xin = seen[0]
        b, s_loc = xin.shape[0], xin.shape[1]
        # under SP the layer sees the mp rank's chunk of the columns (of
        # its sep chunk's under context parallelism), padded to a
        # multiple of mp
        valid = None
        if spec[4]:
            pad = _padded(len(cols), spec) - len(cols)
            cols = np.concatenate([cols, np.full(pad, S)])
            cols = cols.reshape(spec[1], -1)[mp_rank]
            valid = torch.from_numpy(cols < S).repeat(b)
        cap = capacity(2, B * seq, spec[6], mlp.capacity_factor)
        _, _, routed, _ = mlp.route(xin.reshape(b * s_loc, -1), cap, b,
                                    valid)
    out = set()
    for r in routed:
        for t, v in enumerate(r.tolist()):
            if v < spec[6] * cap:
                g = int(rows[t // s_loc]) * seq + int(cols[t % s_loc])
                out.add((g, v // cap, v % cap))
    return out


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


def _run(root, name):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaForCausalLM, LlamaForCausalLMPipe, gather_jax_layout,
        load_jax_weights,
    )
    from paddle_tpu_torch.models import llama as tllama
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    spec = CONFIGS[name]
    dp, mp, pp, sep = spec[:4]
    fleet.init(is_collective=True,
               strategy=_strategy(dp=dp, mp=mp, pp=pp, sep=sep))
    hcg = fleet.get_hybrid_communicate_group()
    with open(f"{root}/{name}.weights.pkl", "rb") as f:
        weights = pickle.load(f)
    seq = SEQ.get(name, S)
    (x, y), rows, cols = _rank_inputs(spec, hcg, seq)
    cfg = _config(tllama, spec, moe_expert_axis=AXIS.get(name, "dp"))
    clip = ClipGradByGlobalNorm(1.0)
    if pp > 1:
        model = LlamaForCausalLMPipe(cfg, device="cpu")
        load_jax_weights(model, weights)
        net = fleet.distributed_model(model)
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=model.parameters(), grad_clip=clip)
        if name in ZERO:
            _, opt, _ = group_sharded_parallel(net, opt, level=ZERO[name])
        out = {"loss": float(net.forward_backward_pipeline((x, y)))}
        net._reduce_gradients(opt)
        out["grads"] = gather_jax_layout(model, grads=True) \
            if name not in ZERO else _zero_grads(model, opt)
        out["counters"] = dict(model.counters)
        out["stage"] = hcg.get_stage_id()
        opt.clear_grad()
        out["steps"] = [float(net.train_batch((x, y), opt))
                        for _ in range(STEPS)]
        out["params"] = gather_jax_layout(model)
        return out
    model = LlamaForCausalLM(cfg, device="cpu")
    load_jax_weights(model, weights)
    out = {}
    if spec[6]:
        out["dispatched"] = _dispatched(model, x, spec, rows, cols,
                                        hcg.get_model_parallel_rank(), seq)
        out["experts"] = model.llama.layers[0].mlp.w_in.shape[0]
    net = fleet.distributed_model(model)
    loss = net(x, y)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = gather_jax_layout(model, grads=True)
    model.zero_grad(set_to_none=True)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01,
        parameters=model.parameters(), grad_clip=clip))
    step = TrainStep(net, opt, lambda m, i, l: m(i, l))
    out["steps"] = [float(step(x, y)) for _ in range(STEPS)]
    out["params"] = gather_jax_layout(model)
    return out


def _errors():
    """The combinations still refused, and those no longer refused, in
    one order on every rank (4): each message, None where it builds."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, LlamaForCausalLMPipe,
    )
    from paddle_tpu_torch.optimizer import LBFGS

    errors = []

    def attempt(fn, kind=NotImplementedError):
        try:
            fn()
        except kind as e:
            errors.append(str(e))
        else:
            errors.append(None)

    fleet.init(is_collective=True, strategy=_strategy(mp=2, sep=2))
    attempt(lambda: LlamaForCausalLM(LlamaConfig.tiny(
        moe_num_experts=4, moe_expert_axis="mp", sequence_parallel=True),
        device="cpu"))
    attempt(lambda: MoELayer(16, 32, 4, expert_axis="sep", device="cpu"))
    fleet.init(is_collective=True, strategy=_strategy(dp=2, mp=2))
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    attempt(lambda: fleet.distributed_optimizer(
        LBFGS(parameters=model.parameters())))
    attempt(lambda: LlamaForCausalLMPipe(
        LlamaConfig.tiny(vocab_size=127), device="cpu"), ValueError)
    # under pp, train_batch steps without a closure: LBFGS raises there,
    # as the reference's does
    fleet.init(is_collective=True, strategy=_strategy(mp=2, pp=2))
    pipe = LlamaForCausalLMPipe(LlamaConfig.tiny(num_hidden_layers=2),
                                device="cpu")
    net = fleet.distributed_model(pipe)
    ids = torch.zeros((2, 8), dtype=torch.int64)
    attempt(lambda: net.train_batch(
        (ids, ids), LBFGS(parameters=pipe.parameters())), ValueError)
    tdist.barrier()
    return errors


def _worker(root, names):
    _child_setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    for name in names:
        out = _errors() if name == "errors" else _run(root, name)
        with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference, [each rank's results])}: the ranks of each world
    size spawned once."""
    root = tmp_path_factory.mktemp("hybrid")
    weights, refs = {}, {}
    for name in CONFIGS:
        if name not in SAME_REFERENCE:
            weights[name], refs[name] = _reference(name)
    for name, same in SAME_REFERENCE.items():
        weights[name], refs[name] = weights[same], refs[same]
    out = {}
    for world, names in WORLDS.items():
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name in names:
            if name in weights:
                with open(sub / f"{name}.weights.pkl", "wb") as f:
                    pickle.dump(weights[name], f)
        spawn(_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            out[name] = (refs.get(name), ranks)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_gradients_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["loss"] - ref["loss"]) <= TOL, (o["loss"], ref["loss"])
        assert set(o["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            _close(o["grads"][n], g, n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_clipped_adamw_steps_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("name", [n for n in CONFIGS
                                  if n.startswith("moe")])
def test_gate_dispatches_the_references_tokens(runs, name):
    """Under SP and context parallelism each rank routes its column chunk
    of its rows into the global slots: the union is the reference's
    (token, expert, slot) set."""
    ref, ranks = runs[name]
    got = set().union(*(o["dispatched"] for o in ranks))
    assert got == ref["dispatched"]
    # every rank routes its own tokens: the sets of two ranks that hold
    # other tokens do not meet
    seen = {}
    for o in ranks:
        for tok, e, slot in o["dispatched"]:
            seen.setdefault((e, slot), set()).add(tok)
    assert all(len(t) == 1 for t in seen.values())
    # a padded column is never dispatched: every token is a real one
    assert all(tok < B * SEQ.get(name, S) for tok, _, _ in got)
    # each rank holds E over the degree of its expert axes
    spec = CONFIGS[name]
    axes = AXIS.get(name, "dp")
    degree = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        degree *= {"dp": spec[0], "mp": spec[1], "sep": spec[3]}[a]
    assert all(o["experts"] == spec[6] // degree for o in ranks)


@pytest.mark.parametrize("name", [n for n, c in CONFIGS.items()
                                  if c[2] > 1])
def test_pipe_sends_the_sequence_chunk(runs, name):
    """What crosses the stage boundary is ``[mb, s / mp, h]`` under SP and
    ``[mb, s / sep, h]`` under context parallelism, fp32: one activation
    forward and one gradient back per microbatch, and the counters count
    those bytes."""
    dp, mp, _, sep, sp = CONFIGS[name][:5]
    _, ranks = runs[name]
    s_local = _padded(SEQ.get(name, S), CONFIGS[name]) \
        // (sep * (mp if sp else 1))
    mb = B // N_MICRO // dp
    for o in ranks:
        c = o["counters"]
        assert c["sends"] == N_MICRO, c
        assert c["bytes_sent"] == N_MICRO * mb * s_local * H * 4, c


def test_remaining_combinations_raise_naming_their_item(runs):
    """The experts over mp under SP or over sep, and LBFGS over the ranks,
    build (a sep chunk mp does not divide under SP and context
    parallelism runs: ``moe_mp2_sep2_sp_s14``); a vocab mp does not
    divide raises as the reference's does; under pp LBFGS raises for
    want of a closure, as there."""
    _, ranks = runs["errors"]
    for errors in ranks:
        axis_mp_sp, axis_sep, lbfgs, uneven, lbfgs_pp = errors
        assert axis_mp_sp is None and axis_sep is None and lbfgs is None
        assert "vocab_size = 127" in uneven and "mp = 2" in uneven
        assert "reference raises too" in uneven
        assert "closure" in lbfgs_pp


def test_gate_routes_by_the_choices_it_is_handed():
    """``MoELayer._choose`` is the gate's one discrete step, the seam
    through which ``chip_smoke.py``'s bf16 hybrid leg hands its ranks one
    card's choices: handed its own the layer computes the same bits;
    handed others, every kept token lands in a slot of the expert it was
    handed, the slots numbered in token order."""
    from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
        MoELayer, capacity)

    E = 4
    layer = MoELayer(H, 2 * H, E, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(
        np.random.RandomState(0).randn(B, S, H).astype(np.float32))
    want = layer(x)
    own, seen = layer._choose, []
    layer._choose = lambda p: seen.append(own(p)) or seen[-1]
    assert torch.equal(layer(x), want)
    first = (seen[0][0] + 1) % E
    second = seen[0][1]
    second = torch.where(second == first, (first + 1) % E, second)
    layer._choose = lambda p: [first, second]
    cap = capacity(2, B * S, E, layer.capacity_factor)
    rows = layer.route(x.reshape(B * S, H), cap, B)[2]
    for j, (chosen, r) in enumerate(zip((first, second), rows)):
        kept = r < E * cap
        assert kept.any(), j
        assert torch.equal(r[kept] // cap, chosen[kept]), j
        if j == 0:  # first choices fill their expert's slots in order
            for e in range(E):
                slots = r[kept & (chosen == e)] % cap
                assert torch.equal(slots, torch.arange(len(slots))), e
