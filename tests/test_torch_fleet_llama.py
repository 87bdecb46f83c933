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
- ``dp2_mp2``: dp 2 x mp 2, four ranks;
- heads that mp does not divide, their flat width divided (the
  reference's GSPMD cuts the flat columns mid-head; a port rank holds
  whole heads, the first ranks one more): ``mp2_h3`` (3 heads at hidden
  48), ``mp2_h1`` (1 head: rank 1 holds none) and ``mp3_h4`` (4 heads
  over 3 ranks, vocab and FFN 129), K and V replicated in each;
- ``mp2_sp_s15``: SP at a sequence of 15, which the embedding pads to
  16 and the final gather trims;
- ``mp2_chunked``: ``ce_chunk_size=32`` under mp 2 with
  ``use_parallel_cross_entropy=False``, the chunked loss over each
  rank's vocab columns of the LM head.

Held, each against the reference within ``TOL``: the logits (the
ranks' shards put together by batch and vocab), the loss on every rank,
every gradient (through ``gather_jax_layout``), and the losses of 3
``AdamW`` steps with ``ClipGradByGlobalNorm(1.0)`` through
``fleet.distributed_model``/``distributed_optimizer`` and ``TrainStep``,
and the parameters after them (within ``PARAM_TOL``, see there); under
``mp2`` and ``mp2_gqa`` also 2 ``Lamb`` steps with ``ClipGradByNorm``.
``LBFGS`` over the ranks (``mp2``, ``dp2_mp2``; Armijo and strong Wolfe,
3 steps, history 10): the losses within ``TOL`` of the reference's and
every rank making as many closure calls as the reference. Also: the
parameter dims mp does not divide (vocab, FFN, the flat attention
width) raise naming the dim and the degree, as the reference raises.

Decode under tensor parallelism (``DECODE``, in the same spawns): each
rank's ``generate()`` and ``ServingEngine`` decode from its own shards
(no whole weight gathered) the reference's tokens on its mesh, at mp 2
with 4, 2 and 1 kv heads (1: ``nkv % mp != 0``, a rank's q heads
reading kv heads through an offset), dp 2 x mp 2 (each dp rank decodes
its rows), int8 weights with int8 pools, speculative decoding
(``spec_k=3``) and a seeded sampled decode (JAX's Gumbel draws handed
to every rank); step 1's logits within ``TOL``; each rank's stacked
decode weights and pools at their local shapes.
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
# name: (dp, mp, num_key_value_heads, sequence_parallel, more of the
# config, sequence length)
CONFIGS = {
    "mp2": (1, 2, 2, False, {}, S),
    "mp2_sp": (1, 2, 2, True, {}, S),
    "mp2_gqa": (1, 2, 1, False, {}, S),
    "dp2": (2, 1, 2, False, {}, S),
    "dp2_mp2": (2, 2, 2, False, {}, S),
    "mp2_h3": (1, 2, 3, False, dict(hidden_size=48, num_attention_heads=3),
               S),
    "mp2_h1": (1, 2, 1, False, dict(num_attention_heads=1), S),
    "mp3_h4": (1, 3, 4, False, dict(hidden_size=48, vocab_size=129,
                                    intermediate_size=129), S),
    "mp2_sp_s15": (1, 2, 2, True, {}, 15),
    "mp2_chunked": (1, 2, 2, False, dict(use_parallel_cross_entropy=False,
                                         ce_chunk_size=32), S),
}
# LBFGS over the ranks: (config, line search). The reference's result
# does not depend on its layout (its arrays are global): it runs on
# mp2's mesh, and dp2_mp2's ranks are held to it too
LBFGS_CASES = [(n, search) for n in ("mp2", "dp2_mp2")
               for search in (None, "strong_wolfe")]
LBFGS_STEPS = 3


def _batch(seq=S):
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 4:6] = -100  # the first dp shard: 5 ignored, the second 0
    return ids[:, :seq], labels[:, :seq]


def _lbfgs(opt_cls, model, step_fn, search):
    """``LBFGS_STEPS`` steps of L-BFGS with ``search``: the losses and
    the closure calls of each step."""
    calls = [0]

    def closure():
        calls[0] += 1
        loss = step_fn()
        loss.backward()
        return loss

    opt = opt_cls(learning_rate=1.0, max_iter=4, history_size=10,
                  line_search_fn=search, parameters=model.parameters())
    losses, counts = [], []
    for _ in range(LBFGS_STEPS):
        calls[0] = 0
        v = opt.step(closure)
        losses.append(float(v) if isinstance(v, torch.Tensor)
                      else float(v.numpy()))
        counts.append(calls[0])
    return losses, counts


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _llama_worker(root, names):
    """One rank: every config in ``names`` in turn (``DECODE``'s through
    :func:`_decode_rank`), results pickled to
    ``root/{name}.{rank}.pkl``."""
    _child_setup()
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, gather_jax_layout, load_jax_weights,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
    from paddle_tpu_torch.optimizer import LBFGS, AdamW, Lamb

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    for name in names:
        if name in DECODE or name == "errors":
            out = _decode_rank(root, name) if name in DECODE \
                else _uneven_errors()
            with open(f"{root}/{name}.{dist.get_rank()}.pkl", "wb") as f:
                pickle.dump(out, f)
            continue
        dp, mp, nkv, sp, more, seq = CONFIGS[name]
        ids, labels = (torch.from_numpy(a) for a in _batch(seq))
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
        fleet.init(is_collective=True, strategy=strategy)
        hcg = fleet.get_hybrid_communicate_group()
        with open(f"{root}/{name}.weights.pkl", "rb") as f:
            weights = pickle.load(f)
        cfg = LlamaConfig.tiny(num_hidden_layers=2, num_key_value_heads=nkv,
                               sequence_parallel=sp, **more)
        model = LlamaForCausalLM(cfg, device="cpu")
        load_jax_weights(model, weights)
        r, b = hcg.get_data_parallel_rank(), B // dp
        mine = slice(r * b, (r + 1) * b)
        x, y = ids[mine], labels[mine]
        attn = model.llama.layers[0].self_attn
        out = {"coords": (r, hcg.get_model_parallel_rank()),
               "sp_layer": type(attn.qkv_proj).__name__,
               "heads": attn._nh}
        net = fleet.distributed_model(model)
        with torch.no_grad():
            logits = net(x)
        if not cfg.use_parallel_cross_entropy and mp > 1:
            # the head gathers its output: keep this rank's vocab columns
            logits = logits.chunk(mp, -1)[hcg.get_model_parallel_rank()]
        out["logits"] = logits.numpy()
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
        for case, search in LBFGS_CASES:
            if case == name:
                load_jax_weights(model, weights)
                out[f"lbfgs_{search}"] = _lbfgs(
                    lambda **kw: fleet.distributed_optimizer(LBFGS(**kw)),
                    model, lambda: net(x, y), search)
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

    dp, mp, nkv, sp, more, seq = CONFIGS[name]
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        cfg = JaxConfig.tiny(num_hidden_layers=2, num_key_value_heads=nkv,
                             sequence_parallel=sp, **more)
        pt.seed(11)
        jm = JaxLlama(cfg)
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        ids, labels = (pt.to_tensor(a) for a in _batch(seq))
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
        for case, search in LBFGS_CASES:
            if case == name == "mp2":
                pt.seed(11)  # the same weights again
                jm = JaxLlama(cfg)
                net = jfleet.distributed_model(jm)
                ref[f"lbfgs_{search}"] = _lbfgs(
                    lambda **kw: jfleet.distributed_optimizer(
                        pt.optimizer.LBFGS(**kw)),
                    jm, lambda: net(ids, labels), search)
    finally:
        jenv.reset_env()
    return weights, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (reference, [each rank's results])}: the ranks of the two
    world sizes spawned once each, for the training configs and the
    decode cases alike."""
    root = tmp_path_factory.mktemp("fleet_llama")
    refs = {}
    for name in list(CONFIGS) + list(DECODE):
        weights, refs[name] = (_decode_reference(name) if name in DECODE
                               else _reference(name))
        with open(root / f"{name}.weights.pkl", "wb") as f:
            pickle.dump(weights, f)
    by_world: dict = {2: ["errors"]}
    for name, (dp, mp) in [(n, c[:2]) for n, c in CONFIGS.items()] + [
            (n, c[:2]) for n, c in DECODE.items()]:
        by_world.setdefault(dp * mp, []).append(name)
    for world, names in sorted(by_world.items()):
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name in names:
            if name in refs:
                os.link(root / f"{name}.weights.pkl",
                        sub / f"{name}.weights.pkl")
        spawn(_llama_worker, args=(str(sub), names), nprocs=world)
        for name in names:
            ranks = []
            for r in range(world):
                with open(sub / f"{name}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            refs[name] = (refs.get(name), ranks)
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
    dp = CONFIGS[name][0]
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


@pytest.mark.parametrize("name", LBFGS_CASES,
                         ids=[f"{n}-{s}" for n, s in LBFGS_CASES])
def test_lbfgs_over_ranks_matches_reference(runs, name):
    """Every rank's L-BFGS losses are the reference's on its global
    arrays, and each step made as many closure calls on every rank as
    there (every rank took the same branches of the search)."""
    case, search = name
    _, ranks = runs[case]
    want_losses, want_calls = runs["mp2"][0][f"lbfgs_{search}"]
    for o in ranks:
        losses, calls = o[f"lbfgs_{search}"]
        np.testing.assert_allclose(losses, want_losses, atol=TOL, rtol=0)
        assert calls == want_calls, (calls, want_calls)
    assert want_losses[-1] < want_losses[0]


def test_ranks_hold_whole_heads_the_first_ranks_one_more(runs):
    """Where mp does not divide the heads each rank attends with its
    whole heads (``torch.tensor_split``'s counts; a rank may hold
    none), and the results above match the reference all the same."""
    for name, want in (("mp2_h3", [2, 1]), ("mp2_h1", [1, 0]),
                       ("mp3_h4", [2, 1, 1]), ("mp2", [2, 2])):
        got = sorted(((o["coords"][1], o["heads"]) for o in runs[name][1]))
        assert [h for _, h in got] == want, (name, got)


def test_layers_are_the_sequence_parallel_ones_under_sp(runs):
    assert {o["sp_layer"] for o in runs["mp2_sp"][1]} == {
        "ColumnSequenceParallelLinear"}
    assert {o["sp_layer"] for o in runs["mp2"][1]} == {
        "ColumnParallelLinear"}


def _uneven_errors():
    """What the parameter dims mp 2 does not divide raise, as the
    reference raises on them (vocab, FFN, the flat attention width), and
    what ``fleet.distributed_optimizer`` makes of ``LBFGS`` (itself)."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import LBFGS

    fleet.init(strategy=_strategy(mp=2))
    errors = []
    for kw in ({"vocab_size": 127}, {"intermediate_size": 129},
               {"hidden_size": 45, "num_attention_heads": 3}):
        try:
            LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1, **kw),
                             device="cpu")
        except ValueError as e:
            errors.append(str(e))
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    opt = LBFGS(parameters=model.parameters())
    errors.append(fleet.distributed_optimizer(opt) is opt)
    return errors


def _strategy(**degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return s


def test_uneven_splits_and_lbfgs_over_ranks_raise(runs):
    """The parameter dims mp does not divide raise, naming the dim and
    the degree and saying the reference raises too (it pads none of
    them); ``LBFGS`` over the ranks is no longer refused (its runs:
    ``test_lbfgs_over_ranks_matches_reference``)."""
    for errors in runs["errors"][1]:
        assert len(errors) == 4, errors
        assert "vocab_size = 127" in errors[0] and "mp = 2" in errors[0]
        assert "intermediate_size = 129" in errors[1]
        assert "flat attention width" in errors[2] and "45" in errors[2]
        for e in errors[:3]:
            assert "reference raises too" in e and "pad" not in e, e
            assert "A.6" not in e, e
        assert errors[3] is True


# -- decode under tensor parallelism ----------------------------------------------

GEN_NEW = 4
GEN_B, GEN_PROMPT = 2, 8
# name: (dp, mp, num_key_value_heads, generate()'s options, engine's,
# more of the config)
SAMPLING = dict(do_sample=True, temperature=0.7, top_k=20, top_p=0.9,
                seed=3)
DECODE = {
    "gen_mp2": (1, 2, 4, {}, {}, {}),
    "gen_mp2_kv2": (1, 2, 2, {}, {}, {}),
    "gen_mp2_kv1": (1, 2, 1, {}, {}, {}),
    "gen_dp2_mp2": (2, 2, 2, {}, {}, {}),
    "gen_int8": (1, 2, 1, dict(int8_weights=True, kv_int8=True),
                 dict(int8_weights=True, kv_int8=True), {}),
    "gen_spec3": (1, 2, 2, {}, dict(spec_k=3), {}),
    "gen_sampled": (1, 2, 2, SAMPLING, None, {}),
    # heads that mp does not divide: each rank decodes its whole heads
    "gen_mp2_h3": (1, 2, 3, {}, {}, dict(hidden_size=48,
                                         num_attention_heads=3)),
    "gen_mp2_h1": (1, 2, 1, {}, {}, dict(num_attention_heads=1)),
    # (d 24: the paged kernels take head dims in multiples of 8)
    "gen_mp3_h4": (1, 3, 4, {}, {}, dict(hidden_size=96, vocab_size=129,
                                         intermediate_size=129)),
}


def _gen_ids():
    return np.random.RandomState(17).randint(
        0, V, (GEN_B, GEN_PROMPT)).astype(np.int32)


def _jax_gumbel(seed, steps, shape):
    """The Gumbel noise the reference's ``generate`` draws, step by step:
    its key split once per sampled token."""
    import jax
    import jax.numpy as jnp

    key, out = jax.random.key(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return out


def _decode_reference(name):
    """The reference's weights for decode case ``name`` and its results on
    its mesh: the tokens of ``generate()`` (and, for ``gen_mp2``, again
    after the LM head is negated), step 1's logits, and under sampling
    the noise it drew."""
    import jax.numpy as jnp

    import paddle_tpu as pt
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu.models import generate as jax_generate
    from paddle_tpu.models import generation as jgen

    dp, mp, nkv, opts, _, more = DECODE[name]
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp}
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        pt.seed(11)
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=2,
                                     num_key_value_heads=nkv, **more))
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        ids = _gen_ids()
        ref = {"tokens": jax_generate(jm, pt.to_tensor(ids),
                                      max_new_tokens=GEN_NEW,
                                      **opts).numpy()}
        int8 = opts.get("int8_weights", False)
        cfg = jgen._GenCfg(jm.config)
        cache = jnp.zeros((2, GEN_B, GEN_PROMPT, nkv,
                           cfg.hidden_size // cfg.num_attention_heads))
        ref["logits"] = np.asarray(jgen._forward(
            jgen._collect_params(jm, int8_weights=int8), jnp.asarray(ids),
            cache, cache, jnp.asarray(GEN_PROMPT), cfg,
            kv_int8=opts.get("kv_int8", False))[0])
        if opts.get("do_sample"):
            ref["noise"] = _jax_gumbel(opts["seed"], GEN_NEW,
                                       (GEN_B, jm.config.vocab_size))
        if name == "gen_mp2":
            jm.lm_head.weight.set_value(-jm.lm_head.weight)
            ref["flipped"] = jax_generate(jm, pt.to_tensor(ids),
                                          max_new_tokens=GEN_NEW).numpy()
        ref["whole"] = {n: a.shape for n, a in weights.items()}
    finally:
        jenv.reset_env()
    return dict(weights, _noise=ref.get("noise")), ref


def _shapes(pack):
    """Each stacked decode weight's shape (an int8 pack's int8 tensor)."""
    return {k: tuple((v["q"] if isinstance(v, dict) else v).shape)
            for k, v in pack.items()}


def _decode_rank(root, name):
    """One rank of decode case ``name``: ``generate()`` and the engine on
    its dp rank's rows, step 1's logits, and the local shapes."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import (
        LlamaConfig, LlamaForCausalLM, generate, load_jax_weights,
    )
    from paddle_tpu_torch.models import generation as tgen
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    dp, mp, nkv, opts, engine, more = DECODE[name]
    fleet.init(is_collective=True, strategy=_strategy(dp=dp, mp=mp))
    hcg = fleet.get_hybrid_communicate_group()
    with open(f"{root}/{name}.weights.pkl", "rb") as f:
        weights = pickle.load(f)
    noise = weights.pop("_noise")
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2,
                                              num_key_value_heads=nkv,
                                              **more),
                             device="cpu")
    load_jax_weights(model, weights)
    r = hcg.get_data_parallel_rank()
    rows = slice(r * GEN_B // dp, (r + 1) * GEN_B // dp)
    ids = _gen_ids()[rows]
    out = {"coords": (r, hcg.get_model_parallel_rank()), "rows": rows}
    if noise is not None:  # the reference's draws, on every rank
        draws = iter(noise)
        own = tgen._gumbel
        tgen._gumbel = lambda shape, gen, dev: torch.from_numpy(
            next(draws)[rows])
        try:
            out["generate"] = generate(model, ids, max_new_tokens=GEN_NEW,
                                       device="cpu", **opts).numpy()
        finally:
            tgen._gumbel = own
        # the port's own draws: every mp rank draws the same
        out["own_draws"] = generate(model, ids, max_new_tokens=GEN_NEW,
                                    device="cpu", **opts).numpy()
    else:
        out["generate"] = generate(model, ids, max_new_tokens=GEN_NEW,
                                   device="cpu", **opts).numpy()
    if engine is not None:
        eng = ServingEngine(model, ServingConfig(max_seq_len=32, **engine),
                            device="cpu")
        reqs = [eng.submit(row, max_new_tokens=GEN_NEW) for row in ids]
        done = eng.run()
        out["engine"] = np.stack([np.asarray(done[q.request_id])
                                  for q in reqs])
        out["pools"] = [tuple(t.shape) for t in
                        (eng._kpool, eng._vpool, eng._kscale, eng._vscale)
                        if t is not None]
        out["phase_modes"] = eng.stats()["phase_modes"]
    int8 = opts.get("int8_weights", False)
    tp = tgen._tensor_parallel(model)
    cfg = tgen._GenCfg(model.config, tp)
    params = tgen._collect_params(model, int8_weights=int8)
    out["shapes"] = _shapes(params)
    cache = torch.zeros((2, len(ids), GEN_PROMPT, cfg.num_key_value_heads,
                         cfg.head_dim))
    out["logits"] = tgen._forward(
        params, torch.from_numpy(ids), cache, cache.clone(), GEN_PROMPT,
        cfg, kv_int8=opts.get("kv_int8", False), tp=tp).numpy()
    if name == "gen_mp2":
        with torch.no_grad():  # a shard written in place rebuilds them
            model.lm_head.weight.mul_(-1)
        out["flipped"] = generate(model, ids, max_new_tokens=GEN_NEW,
                                  device="cpu").numpy()
    return out


def _local_shapes(name, whole, mp_rank):
    """What mp rank ``mp_rank`` of case ``name`` must hold: each stacked
    decode weight at its local shape (``whole``: the reference's global
    parameter shapes), and the kv heads its q heads read, which its
    pools hold."""
    _, mp, nkv, _, _, more = DECODE[name]
    h, vocab = whole["lm_head.weight"]
    nh = more.get("num_attention_heads", 4)
    d = h // nh
    ffn = whole["llama.layers.0.mlp.down_proj.weight"][0]
    # whole heads, the first nh % mp ranks one more
    heads = nh // mp + (mp_rank < nh % mp)
    q0 = mp_rank * (nh // mp) + min(mp_rank, nh % mp)
    rep = nh // nkv
    kv = 0 if heads == 0 else (q0 + heads - 1) // rep - q0 // rep + 1
    return {"ln1": (2, h), "qkv": (2, h, (heads + 2 * kv) * d),
            "o": (2, heads * d, h), "ln2": (2, h),
            "gate_up": (2, h, 2 * ffn // mp), "down": (2, ffn // mp, h),
            "embed": (vocab // mp, h), "norm": (h,),
            "lm_head": (h, vocab // mp)}, kv


# the decode weights that are sharded in training (the norms are whole)
SHARDED = {"qkv": "self_attn.qkv_proj", "o": "self_attn.o_proj",
           "gate_up": "mlp.gate_up_proj", "down": "mlp.down_proj"}


def _hold_decode(runs, name, keys=("generate", "engine")):
    """Every rank's tokens equal the reference's rows, step 1's logits
    within ``TOL``, and its decode weights and pools local."""
    ref, ranks = runs[name]
    whole = ref["whole"]
    for o in ranks:
        want_shapes, kv = _local_shapes(name, whole, o["coords"][1])
        rows = o["rows"]
        for key in keys:
            if key in o:
                np.testing.assert_array_equal(
                    o[key], ref["tokens"][rows],
                    err_msg=f"{name} {key} {o['coords']}")
        _close(o["logits"], ref["logits"][rows], f"{name} logits")
        assert o["shapes"] == want_shapes, (o["shapes"], want_shapes)
        for k, leaf in SHARDED.items():
            full = (2,) + whole[f"llama.layers.0.{leaf}.weight"]
            # (a rank holding every q head, the 1 of gen_mp2_h1, holds
            # the whole qkv: its K and V are replicated)
            assert o["shapes"][k] != full or want_shapes[k] == full, \
                (k, full)
        assert o["shapes"]["embed"] != whole["llama.embed_tokens.weight"]
        assert o["shapes"]["lm_head"] != whole["lm_head.weight"]
        if "pools" in o:
            d = whole["lm_head.weight"][0] \
                // DECODE[name][5].get("num_attention_heads", 4)
            assert all(p[3] == kv for p in o["pools"]), o["pools"]
            assert all(p[4] == d for p in o["pools"][:2]), o["pools"]
            assert set(o["phase_modes"].values()) == {"eager"}


def test_generate_and_engine_at_mp2_match_reference(runs):
    """The reference decodes the tiny Llama at mp 2 on its mesh; the
    port's two ranks decode the same weights through ``generate()`` and
    ``ServingEngine``, each from its own shards, and give the
    reference's tokens, and again after ``lm_head``'s shards are written
    in place."""
    ref, ranks = runs["gen_mp2"]
    want, flipped = ref["tokens"], ref["flipped"]
    assert not np.array_equal(want, flipped)
    for got in ranks:
        r = got["coords"]
        assert got["generate"].shape == (2, GEN_NEW)
        np.testing.assert_array_equal(got["generate"], want, err_msg=f"{r}")
        np.testing.assert_array_equal(got["engine"], want, err_msg=f"{r}")
        np.testing.assert_array_equal(got["flipped"], flipped,
                                      err_msg=f"{r}")
    _hold_decode(runs, "gen_mp2")


@pytest.mark.parametrize("name", [n for n in DECODE if n != "gen_mp2"])
def test_sharded_decode_matches_reference(runs, name):
    """Each case's ranks decode the reference's tokens from their shards
    (the module note); under sampling from the reference's draws, and
    with the port's own generator every mp rank draws alike."""
    _hold_decode(runs, name)
    if DECODE[name][3].get("do_sample"):
        _, ranks = runs[name]
        assert all(np.array_equal(o["own_draws"], ranks[0]["own_draws"])
                   for o in ranks)
