"""ERNIE under tensor parallelism, and attention dropout on global
coordinates, held against the JAX package on its virtual CPU mesh.

The reference runs in this process (``fleet.init`` on its 8 virtual
devices); the port's ranks are processes spawned by
``paddle_tpu_torch.distributed.spawn`` on gloo (a ``file://`` store
under the test's directory, one thread each), which import neither
``jax`` nor ``paddle_tpu`` (asserted). Weights, batches and the
reference's dropout seed words reach them as pickles.

Attention dropout (ROADMAP C.4). On the CPU the reference's
``scaled_dot_product_attention`` takes its composite (a
``jax.random.bernoulli`` mask) unless the Pallas kernel is registered
for the platform; on the TPU it takes the kernel, whose counter-hash
mask hashes the global query head ``b * h + i`` (under GSPMD its arrays
are global). These tests register the kernel for the CPU in interpret
mode, as ``tests/test_pallas_flash.py`` does, so the reference draws the
TPU's mask, and hand the port the same seed words (the reference's
``next_key`` words, recorded). The tiny BERT at dp 2 and the tiny ERNIE
at dp 2 and mp 2, hidden dropout 0 and attention dropout
0.1, in training mode: the logits (each rank's rows) and every gradient
of a fixed linear function of them (summed over the dp ranks) within
``TOL``. A rank that hashes its own launch's coordinates instead (the
port before the repair, ``_dropout_coords`` stubbed to None) drops other
elements: its logits differ.

ERNIE under mp (no dropout): ``ErnieForPretraining`` at mp 2 and dp 2 x
mp 2 (the joint loss, every gradient through ``gather_jax_layout``, 2
``AdamW`` steps with ``ClipGradByGlobalNorm(1.0)``: losses within
``TOL``, parameters within ``PARAM_TOL``) and
``ErnieForSequenceClassification`` (logits and gradients); the pipe
``ErnieForPretrainingPipe`` at pp 2 x mp 2 on both tasks (loss,
canonical gradients, 2 ``train_batch`` steps, ``eval_batch``); the
fused ``qkv`` weight and bias cut segment by segment by
``load_jax_weights`` and put back bit for bit by ``gather_jax_layout``;
``pretrain_heads_mp2``: trunk and branch heads that mp 2 does not divide
(3 of each: a rank holds 2, the other 1), against the reference at the
same config; and the parameter dims mp does not divide (vocab, FFN,
flat attention widths), each raising ``ValueError`` naming its dim, as
the reference raises.
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
# as tests/test_torch_fleet_llama.py: Adam moves each weight by about
# lr * sign(g) at first, so a gradient near 0 whose sign the two
# packages' summation orders flip moves it ~2 lr apart
PARAM_TOL = 2e-3
STEPS = 2
# the tiny ERNIE cut to 2 trunk blocks and 1 block a branch (the
# reference's eager steps dominate the file's time); with dropout, 1 trunk
# block (its interpret-mode kernel calls do)
DEPTH = dict(num_hidden_layers=2, num_task_layers=1)
DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1,
            num_hidden_layers=1, num_task_layers=1)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               **DEPTH)
BERT_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1)
# attention dropout against the reference's kernel route: name ->
# (model, dp, mp, this rank hashes its launch's own coordinates). The
# reference's result does not depend on its layout (GSPMD keeps the
# global meaning), so ERNIE's is computed once, on the dp 2 x mp 2 mesh,
# for every port layout (REF_LAYOUT); likewise below.
DROPOUT = {"bert_dp2": ("bert", 2, 1, False),
           "ernie_dp2": ("ernie", 2, 1, False),
           "ernie_mp2": ("ernie", 1, 2, False),
           "ernie_dp2_local": ("ernie", 2, 1, True)}
# ERNIE without dropout: name -> (model, dp, mp)
REF_LAYOUT = (2, 2)
MP = {"pretrain_mp2": ("pretrain", 1, 2),
      "pretrain_dp2_mp2": ("pretrain", 2, 2),
      "cls_mp2": ("cls", 1, 2),
      "cls_dp2_mp2": ("cls", 2, 2),
      "pretrain_heads_mp2": ("heads", 1, 2)}
# trunk and branch heads that mp 2 does not divide (their flat widths it
# does), the ``"heads"`` model: pretraining at this config
HEADS = dict(hidden_size=48, num_attention_heads=3, task_hidden_size=24,
             num_task_attention_heads=3)
# the pipe at pp 2 x mp 2: name -> task
PIPE = {"pipe_nlu": "nlu", "pipe_nlg": "nlg"}


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(4, V, (B, S)).astype(np.int32)
    types = rng.randint(0, 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 11:] = 0
    mask[2, 13:] = 0
    mlm = np.where((rng.rand(B, S) < 0.3) & (mask > 0), ids,
                   -100).astype(np.int32)
    mlm[0, 0] = ids[0, 0]
    lm = np.where(mask > 0, ids, -100).astype(np.int32)
    return ids, types, mask, mlm, lm


def _pipe_batch(task):
    rng = np.random.RandomState(9)
    ids = rng.randint(4, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    if task == "nlu":
        labels = np.where(rng.rand(B, S) < 0.25, labels, -100)
    labels[0, :5] = -100
    return ids, labels.astype(np.int32)


def _probes(n_out):
    """Fixed weights of the linear function of the logits whose
    gradients are compared, one per output."""
    rng = np.random.RandomState(3)
    return [rng.randn(B, S, V).astype(np.float32) for _ in range(n_out)]


def _close(got, want, name, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=tol, rtol=0,
                               err_msg=name)


# -- the reference ----------------------------------------------------------------


def _jax_fleet(dp=1, mp=1, pp=1, acc=None):
    from paddle_tpu.distributed import fleet as jfleet

    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp}
    if acc:
        s.pipeline_configs = {"accumulate_steps": acc, "micro_batch_size": 1}
    jfleet.init(is_collective=True, strategy=s)
    return jfleet


def _jax_outputs(jm, model, arrays):
    import paddle_tpu as pt

    ids, types, mask = (pt.to_tensor(a) for a in arrays[:3])
    out = jm(ids, types, mask)
    return list(out) if model == "ernie" else [out]


def _jax_dropout(name):
    """The reference model in training mode with attention dropout
    through its Pallas kernel (interpret mode): weights, the seed words
    it drew, the logits and the gradients of the probe function."""
    import jax

    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.framework import random as jrng
    from paddle_tpu.models import BertConfig, BertForMaskedLM
    from paddle_tpu.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu.ops import registry
    from paddle_tpu.ops.pallas import flash_attention as fa

    model, dp, mp, _ = DROPOUT[name]
    if model == "ernie":
        dp, mp = REF_LAYOUT
    words, draw = [], jrng.next_key

    def recorded():
        key = draw()
        words.append(tuple(int(w) for w in
                           np.asarray(jax.random.key_data(key))))
        return key

    fa.register(platform="cpu", interpret=True)
    jrng.next_key = recorded
    _jax_fleet(dp, mp)
    try:
        pt.seed(3)
        jm = (BertForMaskedLM(BertConfig.tiny(**BERT_DROP)) if model == "bert"
              else ErnieForPretraining(ErnieConfig.tiny(**DROP)))
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        del words[:]  # the keys the weights were drawn with
        outs = _jax_outputs(jm, model, _batch())
        loss = None
        for o, w in zip(outs, _probes(len(outs))):
            part = (o * pt.to_tensor(w)).sum()
            loss = part if loss is None else loss + part
        loss.backward()
        ref = {"logits": [np.asarray(o.numpy()) for o in outs],
               "grads": {n: np.asarray(p.grad.numpy())
                         for n, p in jm.named_parameters()
                         if p.grad is not None},
               "draws": len(words)}
    finally:
        jrng.next_key = draw
        registry.deregister_kernel("flash_attention", "cpu")
        jenv.reset_env()
    return weights, words, ref


def _jax_mp(name):
    """The reference ERNIE (no dropout) at ``name``'s layout."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.models import (
        ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    )

    model, _, _ = MP[name]
    jfleet = _jax_fleet(*REF_LAYOUT)
    try:
        pt.seed(5)
        cfg = ErnieConfig.tiny(**NO_DROP, **(HEADS if model == "heads"
                                            else {}))
        ids, types, mask, mlm, lm = (pt.to_tensor(a) for a in _batch())
        if model == "cls":
            jm = ErnieForSequenceClassification(cfg, num_classes=3)
            weights = {n: np.asarray(p._data)
                       for n, p in jm.named_parameters()}
            logits = jm(ids, types, mask)
            w = np.random.RandomState(4).randn(B, 3).astype(np.float32)
            (logits * pt.to_tensor(w)).sum().backward()
            return weights, {
                "logits": np.asarray(logits.numpy()),
                "grads": {n: np.asarray(p.grad.numpy())
                          for n, p in jm.named_parameters()}}
        jm = ErnieForPretraining(cfg)
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        loss = jm(ids, types, mask, mlm, lm)
        loss.backward()
        ref = {"loss": float(loss.numpy()),
               "grads": {n: np.asarray(p.grad.numpy())
                         for n, p in jm.named_parameters()}}
        jm.clear_gradients()
        net = jfleet.distributed_model(jm)
        opt = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=jm.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
        steps = []
        for _ in range(STEPS):
            loss = net(ids, types, mask, mlm, lm)
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


def _canonical(jm, grads=False):
    """The reference pipe's parameters (or gradients) under canonical
    keys, as numpy."""
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


def _jax_pipe(task):
    """The reference ERNIE pipe at pp 2 x mp 2, 2 microbatches."""
    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.models import ErnieConfig
    from paddle_tpu.models.ernie import ErnieForPretrainingPipe

    jfleet = _jax_fleet(mp=2, pp=2, acc=2)
    try:
        pt.seed(11)
        jm = ErnieForPretrainingPipe(ErnieConfig.tiny(**NO_DROP), task)
        weights = {k: np.asarray(t.numpy())
                   for k, t in jm.state_dict().items()}
        net = jfleet.distributed_model(jm)
        data = tuple(pt.to_tensor(a) for a in _pipe_batch(task))
        ref = {"loss": float(net.forward_backward_pipeline(data).numpy()),
               "grads": _canonical(jm, grads=True)}
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


# -- the port's ranks -------------------------------------------------------------


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _init(dp=1, mp=1, pp=1):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp}
    s.pipeline_configs = {"accumulate_steps": 2, "micro_batch_size": 1}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _load(root, name):
    with open(f"{root}/{name}.pkl", "rb") as f:
        return pickle.load(f)


def _port_dropout(root, name):
    """Logits of this rank's rows and the probe's gradients (gathered
    over mp, this rank's part over dp), the attention dropout seeded
    with the reference's words."""
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.models import (
        BertConfig, BertForMaskedLM, ErnieConfig, ErnieForPretraining,
        gather_jax_layout, load_jax_weights,
    )
    from paddle_tpu_torch.nn.functional import attention as tattn

    model, dp, mp, local = DROPOUT[name]
    hcg = _init(dp, mp)
    weights, words = _load(root, f"{name}.in")
    tm = (BertForMaskedLM(BertConfig.tiny(**BERT_DROP), device="cpu")
          if model == "bert" else
          ErnieForPretraining(ErnieConfig.tiny(**DROP), device="cpu"))
    load_jax_weights(tm, weights)
    it = iter(words)
    trandom.next_seed_words = lambda: next(it)
    if local:
        tattn._dropout_coords = lambda q: None
    r = hcg.get_data_parallel_rank()
    rows = slice(r * B // dp, (r + 1) * B // dp)
    ids, types, mask = (torch.from_numpy(a[rows]) for a in _batch()[:3])
    outs = tm(ids, types, mask)
    outs = list(outs) if model == "ernie" else [outs]
    loss = sum((o * torch.from_numpy(w[rows])).sum()
               for o, w in zip(outs, _probes(len(outs))))
    loss.backward()
    return {"dp": r, "mp": hcg.get_model_parallel_rank(),
            "logits": [o.detach().numpy() for o in outs],
            "grads": gather_jax_layout(tm, grads=True),
            "draws": len(words) - sum(1 for _ in it)}


def _port_mp(root, name):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
        gather_jax_layout, load_jax_weights,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    model, dp, mp = MP[name]
    hcg = _init(dp, mp)
    weights = _load(root, f"{name}.in")
    r = hcg.get_data_parallel_rank()
    rows = slice(r * B // dp, (r + 1) * B // dp)
    ids, types, mask, mlm, lm = (torch.from_numpy(a[rows])
                                 for a in _batch())
    cfg = ErnieConfig.tiny(**NO_DROP, **(HEADS if model == "heads" else {}))
    out = {"dp": r, "mp": hcg.get_model_parallel_rank()}
    if model == "cls":
        tm = ErnieForSequenceClassification(cfg, num_classes=3,
                                            device="cpu")
        load_jax_weights(tm, weights)
        logits = tm(ids, types, mask)
        w = np.random.RandomState(4).randn(B, 3).astype(np.float32)[rows]
        (logits * torch.from_numpy(w)).sum().backward()
        out["logits"] = logits.detach().numpy()
        out["grads"] = gather_jax_layout(tm, grads=True)
        return out
    tm = ErnieForPretraining(cfg, device="cpu")
    if name == "pretrain_mp2":  # the round trip, every bias nonzero
        rng = np.random.RandomState(2)
        noisy = {n: w + rng.randn(*w.shape).astype(np.float32)
                 for n, w in weights.items()}
        load_jax_weights(tm, noisy)
        qkv = tm.ernie.encoder[0].attention.qkv
        out["roundtrip"] = (noisy, gather_jax_layout(tm), {
            k: getattr(qkv, k).detach().numpy().copy()
            for k in ("weight", "bias")})
    load_jax_weights(tm, weights)
    out["heads"] = [tm.ernie.encoder[0].attention.num_heads,
                    tm.ernie.nlu_branch.layer[0].attention.num_heads]
    net = fleet.distributed_model(tm)
    loss = net(ids, types, mask, mlm, lm)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["grads"] = gather_jax_layout(tm, grads=True)
    tm.zero_grad(set_to_none=True)
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=tm.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    step = TrainStep(net, opt, lambda m, *a: m(*a))
    out["steps"] = [float(step(ids, types, mask, mlm, lm))
                    for _ in range(STEPS)]
    out["params"] = gather_jax_layout(tm)
    return out


def _port_pipe(root, name):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (
        ErnieConfig, ErnieForPretrainingPipe, gather_jax_layout,
        load_jax_weights,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    task = PIPE[name]
    hcg = _init(mp=2, pp=2)
    model = ErnieForPretrainingPipe(ErnieConfig.tiny(**NO_DROP), task,
                                    device="cpu")
    load_jax_weights(model, _load(root, f"{name}.in"))
    net = fleet.distributed_model(model)
    data = tuple(torch.from_numpy(a) for a in _pipe_batch(task))
    out = {"stage": hcg.get_stage_id(),
           "loss": float(net.forward_backward_pipeline(data))}
    net._reduce_gradients()
    out["grads"] = gather_jax_layout(model, grads=True)
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01,
                parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    opt.clear_grad()
    out["steps"] = [float(net.train_batch(data, opt)) for _ in range(STEPS)]
    out["params"] = gather_jax_layout(model)
    out["eval"] = float(net.eval_batch(data))
    return out


def _errors():
    """Each uneven split of ERNIE at mp 2, for both the model and the
    pipe."""
    from paddle_tpu_torch.models import (
        ErnieConfig, ErnieForPretraining, ErnieForPretrainingPipe,
    )

    _init(mp=2)
    errors = []
    for kw in ({"vocab_size": 127},
               {"hidden_size": 63, "num_attention_heads": 3},
               {"intermediate_size": 129},
               {"task_hidden_size": 33, "num_task_attention_heads": 3},
               {"task_intermediate_size": 65}):
        for build in (lambda c: ErnieForPretraining(c, device="cpu"),
                      lambda c: ErnieForPretrainingPipe(c, "nlg",
                                                        device="cpu")):
            try:
                build(ErnieConfig.tiny(**kw))
            except ValueError as e:
                errors.append(str(e))
    return errors


def _worker(root, names):
    _child_setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    for name in names:
        if name in DROPOUT:
            out = _port_dropout(root, name)
        elif name in MP:
            out = _port_mp(root, name)
        elif name in PIPE:
            out = _port_pipe(root, name)
        else:
            out = _errors()
        with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference, [each rank's results])}: the ranks of each world
    size spawned once."""
    root = tmp_path_factory.mktemp("ernie_mp")
    inputs, refs = {}, {}
    done = {}  # the reference of each model, computed once
    for name, spec in DROPOUT.items():
        if spec[0] not in done:
            weights, words, ref = _jax_dropout(name)
            done[spec[0]] = ((weights, words), ref)
        inputs[name], refs[name] = done[spec[0]]
    for name, spec in MP.items():
        if spec[0] not in done:
            done[spec[0]] = _jax_mp(name)
        inputs[name], refs[name] = done[spec[0]]
    for name, task in PIPE.items():
        inputs[name], refs[name] = _jax_pipe(task)
    worlds = {2: ["bert_dp2", "ernie_dp2", "ernie_mp2", "ernie_dp2_local",
                  "pretrain_mp2", "cls_mp2", "pretrain_heads_mp2",
                  "errors"],
              4: ["pretrain_dp2_mp2", "cls_dp2_mp2",
                  "pipe_nlu", "pipe_nlg"]}
    out = {}
    for world, names in worlds.items():
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name in names:
            if name in inputs:
                with open(sub / f"{name}.in.pkl", "wb") as f:
                    pickle.dump(inputs[name], f)
        spawn(_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            out[name] = (refs.get(name), ranks)
    return out


def _rows(ranks, dp):
    """Each dp index's results (mp rank 0's)."""
    return [next(o for o in ranks if o["dp"] == r and o["mp"] == 0)
            for r in range(dp)]


# -- attention dropout (C.4) ------------------------------------------------------


def test_one_rank_dropout_is_the_reference_kernels_mask():
    """At one rank the port's ERNIE, fed the reference's seed words,
    drops what the reference's kernel drops: logits and gradients."""
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.models import (
        ErnieConfig, ErnieForPretraining, load_jax_weights,
    )

    weights, words, ref = _jax_dropout("ernie_dp2")
    tm = ErnieForPretraining(ErnieConfig.tiny(**DROP), device="cpu")
    load_jax_weights(tm, weights)
    it = iter(words)
    draw = trandom.next_seed_words
    trandom.next_seed_words = lambda: next(it)
    try:
        ids, types, mask = (torch.from_numpy(a) for a in _batch()[:3])
        outs = tm(ids, types, mask)
    finally:
        trandom.next_seed_words = draw
    loss = sum((o * torch.from_numpy(w)).sum()
               for o, w in zip(outs, _probes(2)))
    loss.backward()
    assert next(it, None) is None  # one draw per attention call
    for o, want in zip(outs, ref["logits"]):
        _close(o.detach().numpy(), want, "logits")
    for n, p in tm.named_parameters():
        _close(p.grad.numpy(), ref["grads"][n], n)


@pytest.mark.parametrize("name", [n for n, c in DROPOUT.items()
                                  if not c[3]])
def test_dropout_under_dp_and_mp_is_the_global_mask(runs, name):
    """Each rank's logits are the reference's rows, and the gradients
    summed over dp are the reference's: the ranks hash their rows and
    heads at the global coordinates."""
    ref, ranks = runs[name]
    dp = DROPOUT[name][1]
    per_dp = _rows(ranks, dp)
    for j, want in enumerate(ref["logits"]):
        _close(np.concatenate([o["logits"][j] for o in per_dp]), want,
               f"logits {j}")
    for o in ranks:
        assert o["draws"] == ref["draws"] > 0  # one per attention call
        mine = [p for p in per_dp if p["dp"] == o["dp"]][0]
        for j, lg in enumerate(o["logits"]):  # mp ranks agree
            np.testing.assert_array_equal(lg, mine["logits"][j])
    for n, g in ref["grads"].items():
        _close(sum(o["grads"][n] for o in per_dp), g, n)


def test_dropout_on_local_coordinates_is_caught(runs):
    """The fault the repair removes: a dp rank that hashes its launch's
    own batch rows (rank 1's rows hashed as 0, 1) drops other elements
    than the reference's, so its logits differ, while rank 0's (whose
    rows are global rows 0, 1) agree."""
    ref, ranks = runs["ernie_dp2_local"]
    first, second = _rows(ranks, 2)
    half = B // 2
    for j, want in enumerate(ref["logits"]):
        _close(first["logits"][j], want[:half], f"rank 0 logits {j}")
        assert np.abs(second["logits"][j] - want[half:]).max() > 1e-3


# -- ERNIE under mp ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["pretrain_mp2", "pretrain_dp2_mp2",
                                  "pretrain_heads_mp2"])
def test_pretraining_under_mp_matches_reference(runs, name):
    """The joint loss on every rank, every gradient, 2 clipped AdamW
    steps and the parameters after them."""
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["loss"] - ref["loss"]) <= TOL, (o["loss"], ref["loss"])
        assert set(o["grads"]) == set(ref["grads"])
        for n, g in ref["grads"].items():
            _close(o["grads"][n], g, n)
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["cls_mp2", "cls_dp2_mp2"])
def test_classification_under_mp_matches_reference(runs, name):
    ref, ranks = runs[name]
    dp = MP[name][1]
    per_dp = _rows(ranks, dp)
    _close(np.concatenate([o["logits"] for o in per_dp]), ref["logits"],
           "logits")
    for n, g in ref["grads"].items():
        _close(sum(o["grads"][n] for o in per_dp), g, n)


def test_fused_qkv_cut_by_segment_and_put_back_bit_for_bit(runs):
    """``load_jax_weights`` gives mp rank r its q, k and v columns (and
    bias entries) side by side; ``gather_jax_layout`` is its inverse,
    bit for bit, for every parameter (the fused weight and its 1-D bias
    included)."""
    _, ranks = runs["pretrain_mp2"]
    h = 64
    for o in ranks:
        weights, back, local = o["roundtrip"]
        assert set(back) == set(weights)
        for n, full in weights.items():
            np.testing.assert_array_equal(back[n], full, err_msg=n)
        w = weights["ernie.encoder.0.attention.qkv.weight"]
        b = weights["ernie.encoder.0.attention.qkv.bias"]
        r = o["mp"]
        cols = np.concatenate([np.arange(seg * h + r * h // 2,
                                         seg * h + (r + 1) * h // 2)
                               for seg in range(3)])
        np.testing.assert_array_equal(local["weight"], w[:, cols])
        np.testing.assert_array_equal(local["bias"], b[cols])


@pytest.mark.parametrize("name", list(PIPE))
def test_pipe_at_pp2_mp2_matches_reference(runs, name):
    """The pipe's loss on every rank, canonical gradients, 2 clipped
    AdamW ``train_batch`` steps, the parameters after them and the
    ``eval_batch`` loss."""
    ref, ranks = runs[name]
    assert {o["stage"] for o in ranks} == {0, 1}
    for o in ranks:
        assert abs(o["loss"] - ref["loss"]) <= TOL, (o["loss"], ref["loss"])
        assert set(o["grads"]) == set(ref["grads"])
        for k, g in ref["grads"].items():
            _close(o["grads"][k], g, k)
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for k, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][k], atol=PARAM_TOL,
                                       rtol=0, err_msg=k)
        assert abs(o["eval"] - ref["eval"]) <= TOL


def test_uneven_splits_raise_naming_the_dim(runs):
    """The parameter dims mp does not divide raise, for the model and the
    pipe, saying the reference raises too; heads that mp does not divide
    run (``pretrain_heads_mp2``: the ranks hold 2 and 1 heads of the
    trunk and of the branches)."""
    _, ranks = runs["errors"]
    dims = ["vocab_size = 127", "hidden_size = 63",
            "intermediate_size = 129", "task_hidden_size = 33",
            "task_intermediate_size = 65"]
    for errors in ranks:
        assert len(errors) == 2 * len(dims), errors
        for i, dim in enumerate(dims):
            for e in errors[2 * i:2 * i + 2]:
                assert dim in e and "mp = 2" in e, e
                assert "reference raises too" in e and "pad" not in e, e
    heads = sorted((o["mp"], o["heads"])
                   for o in runs["pretrain_heads_mp2"][1])
    assert [h for _, h in heads] == [[2, 2], [1, 1]], heads
