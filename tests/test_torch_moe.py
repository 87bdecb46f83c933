"""The port's mixture-of-experts held against the JAX package's.

``MoELayer`` (``incubate/distributed/models/moe``) on one rank, in this
process, against the reference's layer from the same weights and input
(fp32): top-2 and top-1, with a capacity that keeps every token and one
that drops: the output, the aux loss and every gradient within ``TOL``,
and the tokens dispatched (token, expert, slot) exactly the reference's
(``dispatch`` of its gates). Ties in the gate go to the lowest expert in
both. The plain dense version (``moe_dense``) gives the same output.

The MoE Llama (tiny, 4 experts, 2 layers) at one rank with both loss
paths (the parallel CE and the chunked CE): the loss with its aux term,
every gradient, and 3 ``AdamW`` ``TrainStep``s with
``ClipGradByGlobalNorm(1.0)`` (losses within ``TOL``, parameters within
``PARAM_TOL``).

Spawned ranks on gloo (``paddle_tpu_torch.distributed.spawn``, a
``file://`` store under the test's directory; each world size spawned
once; the children import neither ``jax`` nor ``paddle_tpu``), against
the reference on its virtual mesh:

- ``layer_dp2``: ``MoELayer`` with its experts over dp 2 (top-2, a
  capacity that drops), each rank its half of the tokens: the output,
  the aux loss, the gradients (the gate's summed over the ranks) and
  the dispatched set, global over the ranks;
- ``dp2``: the MoE Llama at dp 2 through ``fleet.distributed_model``
  (the experts' gradients are not summed over dp), with 2 ``Lamb``
  steps as well and the clip's global norm;
- ``dp2_mp2``: dp 2 x mp 2;
- ``dp2_pp2``: the MoE Llama pipe at dp 2 x pp 2 (no aux loss, as the
  reference's pipe has none), each dp rank fed its chunk of each
  microbatch;
- ``MORE``: the MoE Llama with its batch over sharding too, and its
  experts over any batch axis or mp: ``moe_sh2`` (sharding 2, every
  expert on each rank), ``moe_dp2_sh2`` (experts over dp, each
  sharding rank running them on its own tokens' slots),
  ``moe_axis_sharding`` (dp 2 x sharding 2, the experts over sharding),
  ``moe_axis_mp`` (mp 2, the experts over mp, the tokens replicated),
  and under ZeRO ``moe_sh2_p_g_os`` (the experts gain a sharding cut on
  dim 1), ``moe_dp2_os_g`` (the experts stay over dp) and
  ``moe_axis_sharding_os_g`` (ZeRO over sharding, the experts laid out
  over it already: their gradients summed over dp alone); and the
  experts over a tuple of axes: ``moe_axis_dp_sharding`` (dp 2 x
  sharding 2, each rank one expert, both axes reduce-scattering the
  buffer) and ``moe_axis_dp_mp`` (dp 2 x mp 2: the buffer
  reduce-scattered over dp, then each mp rank's part of it, the tokens
  replicated over mp): the loss,
  every gradient and 2 clipped ``AdamW`` steps against the reference,
  the first layer's dispatched (token, expert, slot) set, global over
  the ranks, and each rank's count of experts. The reference's results
  do not depend on the layout (its gate is global): these take those of
  ``moe_axis_sharding``, run on its own mesh (``SAME_REFERENCE``);
- the errors: under sequence and context parallelism and at sharding 2
  the MoE Llama builds (SP and context parallelism held in
  ``tests/test_torch_hybrid.py``).
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.incubate.distributed.models.moe.moe_layer import (
    capacity, moe_dense,
)

TOL = 1e-5
# as tests/test_torch_fleet_llama.py: Adam moves each weight by about
# lr * sign(g) at first, so a gradient near 0 whose sign the two
# packages' summation orders flip moves it ~2 lr apart
PARAM_TOL = 2e-3
STEPS = 3
B, S, V, E = 4, 16, 128, 4
LAYER = dict(d_model=16, d_hidden=32, num_experts=4)
LAYER_CASES = {  # name: (top_k, capacity_factor)
    "top2_keep": (2, 2.0), "top2_drop": (2, 0.5),
    "top1_keep": (1, 4.0), "top1_drop": (1, 0.5)}
CONFIGS = {  # name: (dp, mp, pp)
    "dp2": (2, 1, 1), "dp2_mp2": (2, 2, 1), "dp2_pp2": (2, 1, 2)}
MORE = {  # name: (dp, mp, sharding, moe_expert_axis, ZeRO level)
    "moe_sh2": (1, 1, 2, "dp", None),
    "moe_dp2_sh2": (2, 1, 2, "dp", None),
    "moe_axis_sharding": (2, 1, 2, "sharding", None),
    "moe_axis_mp": (1, 2, 1, "mp", None),
    "moe_sh2_p_g_os": (1, 1, 2, "dp", "p_g_os"),
    "moe_dp2_os_g": (2, 1, 1, "dp", "os_g"),
    "moe_axis_sharding_os_g": (2, 1, 2, "sharding", "os_g"),
    "moe_axis_dp_sharding": (2, 1, 2, ("dp", "sharding"), None),
    "moe_axis_dp_mp": (2, 2, 1, ("dp", "mp"), None),
}
SAME_REFERENCE = {"moe_sh2": "moe_axis_sharding",
                  "moe_dp2_sh2": "moe_axis_sharding",
                  "moe_axis_mp": "moe_axis_sharding",
                  "moe_sh2_p_g_os": "moe_axis_sharding",
                  "moe_dp2_os_g": "moe_axis_sharding",
                  "moe_axis_sharding_os_g": "moe_axis_sharding",
                  "moe_axis_dp_sharding": "moe_axis_sharding",
                  "moe_axis_dp_mp": "moe_axis_sharding"}
N_MICRO = 2
MORE_STEPS = 2  # the AdamW steps of a MORE config


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 4:6] = -100  # the dp shards' counts differ
    return ids, labels


def _layer_input():
    return np.random.RandomState(3).randn(2, 8, 16).astype(np.float32)


def _close(got, want, name, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=tol, rtol=0,
                               err_msg=name)


def _dispatched_set(rows, cap, offset=0):
    """{(token, expert, slot)} from ``MoELayer.route``'s rows."""
    out = set()
    for r in rows:
        for t, v in enumerate(r.tolist()):
            if v < E * cap:
                out.add((t + offset, v // cap, v % cap))
    return out


# -- the reference ----------------------------------------------------------------


def _jax_fleet(dp=1, mp=1, pp=1, acc=None, sharding=1):
    from paddle_tpu.distributed import fleet as jfleet

    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    if acc:
        s.pipeline_configs = {"accumulate_steps": acc, "micro_batch_size": 1}
    jfleet.init(is_collective=True, strategy=s)
    return jfleet


def _jax_layer(top_k, cf, x, dp=1):
    """The reference layer's weights, output, aux loss, gradients (of
    ``sum(y * y) + 0.5 * aux``) and dispatched set."""
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.incubate.distributed.models.moe import MoELayer as JM
    from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml

    _jax_fleet(dp=dp)
    try:
        pt.seed(3)
        jm = JM(**LAYER, top_k=top_k, capacity_factor=cf, activation="silu")
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        xt = pt.to_tensor(x)
        xt.stop_gradient = False
        y = jm(xt)
        aux = jm.aux_loss
        ((y * y).sum() + 0.5 * aux).backward()
        T = x.shape[0] * x.shape[1]
        cap = capacity(top_k, T, LAYER["num_experts"], cf)
        logits = jnp.asarray(x.reshape(T, -1)) @ jnp.asarray(
            weights["gate_weight"])
        gate = jml._top2_gating if top_k == 2 else jml._top1_gating
        dispatch = np.asarray(gate(logits, cap)[1])
        ref = {"y": np.asarray(y.numpy()), "aux": float(aux.numpy()),
               "grads": {n: np.asarray(p.grad.numpy())
                         for n, p in jm.named_parameters()},
               "gx": np.asarray(xt.grad.numpy()),
               "dispatched": {tuple(int(i) for i in ix)
                              for ix in np.argwhere(dispatch > 0)}}
    finally:
        jenv.reset_env()
    return weights, ref


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


def _jax_dispatched(jm, ids):
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
    cap = capacity(2, B * S, E, layer.capacity_factor)
    dispatch = np.asarray(jml._top2_gating(logits, cap)[1])
    return {tuple(int(i) for i in ix) for ix in np.argwhere(dispatch > 0)}


def _jax_llama(name, ids, labels, ce_chunk=0):
    """The reference MoE Llama's (or pipe's) weights and results."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models.llama import LlamaForCausalLMPipe as JaxPipe

    dp, mp, pp = CONFIGS.get(name, (1, 1, 1))
    sh, axis = 1, "dp"
    if name in MORE:
        dp, mp, sh, axis, _ = MORE[name]
    jfleet = _jax_fleet(dp, mp, pp, acc=N_MICRO if pp > 1 else None,
                        sharding=sh)
    try:
        cfg = JaxConfig.tiny(num_hidden_layers=2, moe_num_experts=E,
                             use_parallel_cross_entropy=not ce_chunk,
                             ce_chunk_size=ce_chunk, moe_expert_axis=axis)
        pt.seed(11)
        data = (pt.to_tensor(ids), pt.to_tensor(labels))
        clip = pt.nn.ClipGradByGlobalNorm(1.0)
        if pp > 1:
            jm = JaxPipe(cfg)
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
        jm = JaxLlama(cfg)
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        dispatched = _jax_dispatched(jm, ids) if name in MORE else None
        loss = jm(*data)
        loss.backward()
        ref = {"dispatched": dispatched, "loss": float(loss.numpy()),
               "grads": {n: np.asarray(p.grad.numpy())
                         for n, p in jm.named_parameters()}}
        jm.clear_gradients()
        net = jfleet.distributed_model(jm)
        opt = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=jm.parameters(), grad_clip=clip))
        steps = []
        for _ in range(MORE_STEPS if name in MORE else STEPS):
            loss = net(*data)
            loss.backward()
            opt.step()
            opt.clear_grad()
            steps.append(float(loss.numpy()))
        ref["steps"] = steps
        ref["params"] = {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()}
        if name == "dp2":
            pt.seed(11)
            jm = JaxLlama(cfg)
            net = jfleet.distributed_model(jm)
            opt = pt.optimizer.Lamb(learning_rate=1e-3,
                                    parameters=jm.parameters())
            lamb = []
            for _ in range(2):
                loss = net(*data)
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


# -- one rank, in this process ----------------------------------------------------


def _port_layer(weights, top_k, cf):
    m = MoELayer(**LAYER, top_k=top_k, capacity_factor=cf,
                 activation="silu", device="cpu")
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(np.array(weights[n])))
    return m


def _run_layer(m, x, offset=0):
    """Output, aux loss, gradients (of ``sum(y * y) + aux / 2``) and
    dispatched set of ``m`` on ``x``."""
    xx = torch.from_numpy(x).requires_grad_()
    y = m(xx)
    aux = float(m.aux_loss.detach())
    ((y * y).sum() + 0.5 * m.aux_loss).backward()
    T = x.shape[0] * x.shape[1] * m._n
    cap = capacity(m.top_k, T, E, m.capacity_factor)
    with torch.no_grad():
        _, _, rows, _ = m.route(xx.reshape(-1, xx.shape[-1]), cap)
    return {"y": y.detach().numpy(), "aux": aux,
            "grads": {n: p.grad.numpy() for n, p in m.named_parameters()},
            "gx": xx.grad.numpy(),
            "dispatched": _dispatched_set(rows, cap, offset)}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_reference(case):
    top_k, cf = LAYER_CASES[case]
    x = _layer_input()
    weights, ref = _jax_layer(top_k, cf, x)
    got = _run_layer(_port_layer(weights, top_k, cf), x)
    _close(got["y"], ref["y"], "y")
    assert abs(got["aux"] - ref["aux"]) <= TOL
    _close(got["gx"], ref["gx"], "dx")
    for n, g in ref["grads"].items():
        _close(got["grads"][n], g, n)
    assert got["dispatched"] == ref["dispatched"]
    T = x.shape[0] * x.shape[1]
    kept = {t for t, _, _ in ref["dispatched"]}
    if case.endswith("drop"):  # a token no choice keeps is a zero row
        assert len(ref["dispatched"]) < top_k * T
        gone = sorted(set(range(T)) - kept)
        assert gone or top_k == 2
        assert not np.any(got["y"].reshape(T, -1)[gone])
    else:
        assert len(ref["dispatched"]) == top_k * T


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_dense_plain_version_matches_the_index_form(case):
    top_k, cf = LAYER_CASES[case]
    m = MoELayer(**LAYER, top_k=top_k, capacity_factor=cf,
                 activation="gelu", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_layer_input())
    y = m(x)
    want, aux, _ = moe_dense(x, m.gate_weight, m.w_in, m.w_out, top_k, cf,
                             "gelu")
    torch.testing.assert_close(y, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(m.aux_loss, aux, rtol=0, atol=1e-7)


def test_gate_ties_go_to_the_lowest_expert():
    """A zero gate weight makes every expert tie: both packages send
    every first choice to expert 0 and every second to expert 1."""
    import jax.numpy as jnp

    from paddle_tpu.incubate.distributed.models.moe import moe_layer as jml

    m = MoELayer(**LAYER, device="cpu")
    with torch.no_grad():
        m.gate_weight.zero_()
    tokens = torch.from_numpy(_layer_input().reshape(16, 16))
    _, _, rows, _ = m.route(tokens, 16)
    got = _dispatched_set(rows, 16)
    dispatch = np.asarray(jml._top2_gating(jnp.zeros((16, E)), 16)[1])
    assert got == {tuple(int(i) for i in ix)
                   for ix in np.argwhere(dispatch > 0)}
    assert {e for _, e, _ in got} == {0, 1}


def test_unported_moe_options_raise():
    with pytest.raises(NotImplementedError, match="top_k=3"):
        MoELayer(**LAYER, top_k=3, device="cpu")
    with pytest.raises(ValueError, match="expert_axis='pp'"):
        MoELayer(**LAYER, expert_axis="pp", device="cpu")
    with pytest.raises(ValueError, match="expert_axis=\\('dp', 'pp'\\)"):
        MoELayer(**LAYER, expert_axis=("dp", "pp"), device="cpu")


def _port_llama(weights, device="cpu", **kw):
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, load_jax_weights,
    )

    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                              moe_num_experts=E, **kw),
                             device=device)
    load_jax_weights(model, weights)
    return model


@pytest.mark.parametrize("ce_chunk", [0, 32])
def test_moe_llama_one_rank_matches_reference(ce_chunk):
    """Both loss paths add the aux term; the loss, every gradient and 3
    clipped AdamW steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    ids, labels = _batch()
    weights, ref = _jax_llama("one", ids, labels, ce_chunk)
    model = _port_llama(weights, use_parallel_cross_entropy=not ce_chunk,
                        ce_chunk_size=ce_chunk)
    x, y = torch.from_numpy(ids), torch.from_numpy(labels)
    loss = model(x, y)
    loss.backward()
    assert abs(float(loss.detach()) - ref["loss"]) <= TOL
    assert all(blk.mlp.aux_loss is None for blk in model.llama.layers)
    for n, p in model.named_parameters():
        _close(p.grad.numpy(), ref["grads"][n], n)
    model.zero_grad(set_to_none=True)
    step = TrainStep(model, AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=model.parameters(),
                                  grad_clip=ClipGradByGlobalNorm(1.0)),
                     lambda m, i, l: m(i, l))
    np.testing.assert_allclose([float(step(x, y)) for _ in range(STEPS)],
                               ref["steps"], atol=TOL, rtol=0)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref["params"][n],
                                   atol=PARAM_TOL, rtol=0, err_msg=n)


# -- spawned ranks ----------------------------------------------------------------


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _strategy(dp=1, mp=1, pp=1, **more):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        **{f"{k}_degree": v for k, v in more.items()}}
    s.pipeline_configs = {"accumulate_steps": N_MICRO, "micro_batch_size": 1}
    return s


def _rank_rows(n_rows, dp, r, pp):
    """The rows of the global batch dp rank ``r`` takes: its chunk, or
    under the pipe its chunk of each microbatch."""
    rows = np.arange(n_rows)
    if pp > 1:
        return rows.reshape(N_MICRO, dp, -1)[:, r].reshape(-1)
    return rows.reshape(dp, -1)[r]


def _layer_dp2(root):
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(dp=2))
    hcg = fleet.get_hybrid_communicate_group()
    with open(f"{root}/layer_dp2.weights.pkl", "rb") as f:
        weights = pickle.load(f)
    m = MoELayer(**LAYER, top_k=2, capacity_factor=0.5, activation="silu",
                 device="cpu", generator=False)
    from paddle_tpu_torch.models import gather_jax_layout, load_jax_weights

    load_jax_weights(m, weights)
    r = hcg.get_data_parallel_rank()
    x = _layer_input()
    mine = x[r:r + 1]  # one of the two rows: 8 of the 16 tokens
    out = _run_layer(m, mine, offset=r * mine.shape[1])
    out["grads"] = gather_jax_layout(m, grads=True)
    out["comm_bytes"] = m.comm_bytes
    return out


def _llama_config(root, name):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLMPipe, gather_jax_layout,
        load_jax_weights,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.nn.clip import _sq_norms
    from paddle_tpu_torch.optimizer import AdamW, Lamb

    dp, mp, pp = CONFIGS[name]
    fleet.init(is_collective=True, strategy=_strategy(dp, mp, pp))
    hcg = fleet.get_hybrid_communicate_group()
    with open(f"{root}/{name}.weights.pkl", "rb") as f:
        weights = pickle.load(f)
    ids, labels = _batch()
    rows = _rank_rows(B, dp, hcg.get_data_parallel_rank(), pp)
    x, y = torch.from_numpy(ids[rows]), torch.from_numpy(labels[rows])
    clip = ClipGradByGlobalNorm(1.0)
    if pp > 1:
        model = LlamaForCausalLMPipe(LlamaConfig.tiny(
            num_hidden_layers=2, moe_num_experts=E), device="cpu")
        load_jax_weights(model, weights)
        net = fleet.distributed_model(model)
        out = {"loss": float(net.forward_backward_pipeline((x, y)))}
        net._reduce_gradients()
        out["grads"] = gather_jax_layout(model, grads=True)
        opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                    parameters=model.parameters(), grad_clip=clip)
        opt.clear_grad()
        out["steps"] = [float(net.train_batch((x, y), opt))
                        for _ in range(STEPS)]
        out["params"] = gather_jax_layout(model)
        return out
    model = _port_llama(weights)
    net = fleet.distributed_model(model)
    loss = net(x, y)
    loss.backward()
    out = {"loss": float(loss), "grads": gather_jax_layout(model, grads=True)}
    pairs = [(p, p.grad) for p in model.parameters()]
    out["gnorm"] = float(torch.sqrt(torch.stack(_sq_norms(pairs)).sum()))
    model.zero_grad(set_to_none=True)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=clip))
    step = TrainStep(net, opt, lambda m, i, l: m(i, l))
    out["steps"] = [float(step(x, y)) for _ in range(STEPS)]
    out["params"] = gather_jax_layout(model)
    if name == "dp2":  # Lamb's trust ratio over the expert shards
        load_jax_weights(model, weights)
        opt = Lamb(learning_rate=1e-3, parameters=model.parameters())
        step = TrainStep(net, opt, lambda m, i, l: m(i, l))
        out["lamb"] = [float(step(x, y)) for _ in range(2)]
        out["lamb_params"] = gather_jax_layout(model)
    return out


def _grads(model, opt=None):
    """Every gradient as the reference's global array, also under ZeRO
    (``opt._zero``: its slices gathered over the axis and mp)."""
    from paddle_tpu_torch.models import gather_jax_layout

    plan = getattr(opt, "_zero", None)
    if plan is None:
        return gather_jax_layout(model, grads=True)
    return {n: plan.full(p, g).numpy() for n, p in model.named_parameters()
            for _, g in plan.params_grads([p])}


def _dispatched(model, x, rows):
    """The first MoE layer's dispatched set from this rank's tokens, by
    their global (row * S + column) indices."""
    seen = []
    mlp = model.llama.layers[0].mlp
    handle = mlp.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]) if not seen else None)
    with torch.no_grad():
        model(x)
        handle.remove()
        xin = seen[0]
        cap = capacity(2, B * S, E, mlp.capacity_factor)
        _, _, routed, _ = mlp.route(xin.reshape(-1, xin.shape[-1]), cap,
                                    xin.shape[0])
    out = set()
    for r in routed:
        for t, v in enumerate(r.tolist()):
            if v < E * cap:
                out.add((int(rows[t // S]) * S + t % S, v // cap, v % cap))
    return out


def _llama_more(root, name):
    """A ``MORE`` config on this rank: the dispatched set and the expert
    count, the loss and gradients of one backward, then 3 clipped AdamW
    steps (through ZeRO when the config names a level)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import gather_jax_layout
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    dp, mp, sh, axis, level = MORE[name]
    fleet.init(is_collective=True,
               strategy=_strategy(dp, mp, 1, sharding=sh))
    hcg = fleet.get_hybrid_communicate_group()
    with open(f"{root}/{name}.weights.pkl", "rb") as f:
        weights = pickle.load(f)
    ids, labels = _batch()
    r = hcg.get_data_parallel_rank() * sh + hcg.get_sharding_parallel_rank()
    rows = _rank_rows(B, dp * sh, r, 1)
    x, y = torch.from_numpy(ids[rows]), torch.from_numpy(labels[rows])
    model = _port_llama(weights, moe_expert_axis=axis)
    out = {"dispatched": _dispatched(model, x, rows),
           "experts": [blk.mlp.w_in.shape[0] for blk in model.llama.layers]}
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    if level is None:
        net = fleet.distributed_model(model)
    else:
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        net = model
    loss = net(x, y)
    loss.backward()
    out.update(loss=float(loss.detach()), grads=_grads(model, opt))
    opt.clear_grad()
    step = TrainStep(net, opt, lambda m, i, l: m(i, l))
    out["steps"] = [float(step(x, y)) for _ in range(MORE_STEPS)]
    out["params"] = gather_jax_layout(model)
    return out


def _errors():
    """The MoE Llama built under SP (mp 2), context parallelism (sep 2)
    and sharding 2: the error message of each, None where it builds."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    errors = []
    for degrees, kw in (({"mp": 2}, {"sequence_parallel": True}),
                        ({"sep": 2}, {"context_parallel": True}),
                        ({"sharding": 2}, {})):
        fleet.init(is_collective=True, strategy=_strategy(**degrees))
        try:
            LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1,
                                              moe_num_experts=E, **kw),
                             device="cpu")
        except NotImplementedError as e:
            errors.append(str(e))
        else:
            errors.append(None)
    return errors


def _moe_worker(root, names):
    _child_setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    for name in names:
        if name == "layer_dp2":
            out = _layer_dp2(root)
        elif name == "errors":
            out = _errors()
        elif name in MORE:
            out = _llama_more(root, name)
        else:
            out = _llama_config(root, name)
        with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference, [each rank's results])}: the ranks of each world
    size spawned once."""
    root = tmp_path_factory.mktemp("moe")
    ids, labels = _batch()
    weights, refs = {}, {}
    weights["layer_dp2"], refs["layer_dp2"] = _jax_layer(
        2, 0.5, _layer_input(), dp=2)
    for name in [*CONFIGS, *MORE]:
        if name not in SAME_REFERENCE:
            weights[name], refs[name] = _jax_llama(name, ids, labels)
    for name, same in SAME_REFERENCE.items():
        weights[name], refs[name] = weights[same], refs[same]
    out = {}
    for world, names in ((2, ["layer_dp2", "dp2", "errors", "moe_sh2",
                              "moe_axis_mp", "moe_sh2_p_g_os",
                              "moe_dp2_os_g"]),
                         (4, ["dp2_mp2", "dp2_pp2", "moe_dp2_sh2",
                              "moe_axis_sharding",
                              "moe_axis_sharding_os_g",
                              "moe_axis_dp_sharding", "moe_axis_dp_mp"])):
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name in names:
            if name in weights:
                with open(sub / f"{name}.weights.pkl", "wb") as f:
                    pickle.dump(weights[name], f)
        spawn(_moe_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            out[name] = (refs.get(name), ranks)
    return out


def test_layer_over_dp2_is_the_global_gate(runs):
    """Each rank routes its tokens into the global slots: the output, aux
    loss, gradients and dispatched set are the reference's."""
    ref, ranks = runs["layer_dp2"]
    _close(np.concatenate([o["y"] for o in ranks]), ref["y"], "y")
    _close(np.concatenate([o["gx"] for o in ranks]), ref["gx"], "dx")
    assert set().union(*(o["dispatched"] for o in ranks)) \
        == ref["dispatched"]
    # the replicated gate's gradient is each rank's tokens' part (summed
    # over dp by DataParallel in a model); the experts' are whole
    _close(sum(o["grads"]["gate_weight"] for o in ranks),
           ref["grads"]["gate_weight"], "gate_weight")
    for o in ranks:
        assert abs(o["aux"] - ref["aux"]) <= TOL
        for n in ("w_in", "w_out"):
            _close(o["grads"][n], ref["grads"][n], n)
        # forward: the [E, C, H] buffer reduce-scattered, the outputs
        # all-gathered, fp32
        assert o["comm_bytes"] == 2 * E * capacity(2, 16, E, 0.5) * 16 * 4


@pytest.mark.parametrize("name", [*CONFIGS, *MORE])
def test_moe_llama_loss_and_gradients_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["loss"] - ref["loss"]) <= TOL, (o["loss"], ref["loss"])
        assert set(o["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            _close(o["grads"][n], g, n)


@pytest.mark.parametrize("name", [*CONFIGS, *MORE])
def test_moe_llama_clipped_adamw_steps_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("name", list(MORE))
def test_moe_llama_dispatches_the_references_tokens(runs, name):
    """The first layer's (token, expert, slot) set, global over the
    ranks, is the reference's; ranks that hold other tokens route none
    in common (over mp every rank routes the same tokens); each rank
    holds ``E / degree`` experts of its axes."""
    dp, mp, sh, axis, _ = MORE[name]
    ref, ranks = runs[name]
    assert set().union(*(o["dispatched"] for o in ranks)) \
        == ref["dispatched"]
    if axis == "mp":
        assert all(o["dispatched"] == ref["dispatched"] for o in ranks)
    else:
        seen = {}
        for o in ranks:
            for tok, e, slot in o["dispatched"]:
                seen.setdefault((e, slot), set()).add(tok)
        assert all(len(t) == 1 for t in seen.values())
    degree = 1
    for a in ((axis,) if isinstance(axis, str) else axis):
        degree *= {"dp": dp, "mp": mp, "sharding": sh}[a]
    for o in ranks:
        assert o["experts"] == [E // degree] * 2, o["experts"]


def test_clip_and_lamb_count_the_expert_shards_over_dp(runs):
    """The global norm the clip takes over the ranks' expert shards is
    the reference's gradient norm; Lamb's trust ratios likewise."""
    ref, ranks = runs["dp2"]
    want = np.sqrt(sum(float(np.sum(np.square(g.astype(np.float64))))
                       for g in ref["grads"].values()))
    for o in ranks:
        assert abs(o["gnorm"] - want) <= TOL * want
        np.testing.assert_allclose(o["lamb"], ref["lamb"], atol=TOL, rtol=0)
        for n, p in o["lamb_params"].items():
            np.testing.assert_allclose(p, ref["lamb_params"][n],
                                       atol=PARAM_TOL, rtol=0, err_msg=n)


def test_moe_under_sp_cp_or_sharding_raises(runs):
    """Under SP and context parallelism the MoE Llama builds (its gate
    counts the sequence chunks: ``tests/test_torch_hybrid.py``), and at
    sharding 2 too (its gate counts the sharding ranks' tokens:
    ``MORE``)."""
    _, ranks = runs["errors"]
    for errors in ranks:
        assert errors == [None, None, None], errors
