"""The port's context parallelism (ring and Ulysses attention over
``sep``) held against the JAX package's on its virtual CPU mesh.

The reference runs in this process (``fleet.init`` with ``sep_degree``,
and ``dp_degree``, over its 8 devices), on the global arrays; the port
runs one process per rank, spawned by ``paddle_tpu_torch.distributed.
spawn`` on gloo through a ``file://`` store, each rank holding its
chunk of the sequence (``[b, s/n, ...]``, chunks in sep order) and of
the batch under dp. The children import neither ``jax`` nor
``paddle_tpu`` (they assert it); inputs, weights and results cross as
pickled numpy. On the CPU the port's kernels run their plain versions.

- ``F.ring_flash_attention`` and ``F.ulysses_attention`` at sep 2 and 4,
  causal and full: the output and the gradients of q, k and v of a
  weighted sum, the ranks' chunks put together, against the functions
  the reference's ``F`` entries build on the fleet mesh;
- the tiny Llama (4 layers, 4 heads, 2 kv heads: K and V are repeated
  as the reference repeats them) with ``context_parallel=True``, ring
  and Ulysses, at sep 2 and dp 2 x sep 2 through
  ``fleet.distributed_model``: step 1's loss on every rank, every
  gradient, and 3 ``AdamW`` steps with ``ClipGradByGlobalNorm(1.0)``
  (their losses, then the parameters within ``PARAM_TOL``);
- the degree-1 fallback: at sep 1 both entries are
  ``scaled_dot_product_attention`` and the context-parallel Llama is
  the plain one, bit for bit;
- Ulysses' errors on unequal head counts and on ``h % n``.

Tolerance fp32 1e-5.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import spawn

TOL = 1e-5
PARAM_TOL = 2e-3  # as tests/test_torch_fleet_llama.py
STEPS = 3
B, S, V = 4, 16, 128
ATTN = dict(b=2, s=32, h=4, d=16)
ATTN_CASES = [(mode, sep, causal) for mode in ("ring", "ulysses")
              for sep in (2, 4) for causal in (True, False)]
LLAMA = {  # name: (mode, dp, sep)
    "ring_sep2": ("ring", 1, 2),
    "ulysses_sep2": ("ulysses", 1, 2),
    "ring_dp2_sep2": ("ring", 2, 2),
    "ulysses_dp2_sep2": ("ulysses", 2, 2),
}


def _qkvw():
    rng = np.random.RandomState(3)
    shape = (ATTN["b"], ATTN["s"], ATTN["h"], ATTN["d"])
    return [rng.randn(*shape).astype(np.float32) for _ in range(4)]


def _batch():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, S)).astype(np.int32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 9:12] = -100  # the sequence chunks' counts differ
    return ids, labels


def _llama_config(mode, module):
    return module.LlamaConfig.tiny(num_key_value_heads=2,
                                   context_parallel=True,
                                   context_parallel_mode=mode)


def _child_setup():
    torch.set_num_threads(1)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"a rank process loaded {bad[:5]}"


def _init(root, dp, sep):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "sep_degree": sep}
    fleet.init(is_collective=True, strategy=s)
    return fleet.get_hybrid_communicate_group()


def _attention_case(root, mode, sep, causal):
    """This rank's chunk of the output and of the three gradients."""
    from paddle_tpu_torch.nn import functional as F

    hcg = _init(root, 1, sep)
    c, sl = hcg.get_sep_parallel_rank(), ATTN["s"] // sep
    q, k, v, w = (torch.from_numpy(a[:, c * sl:(c + 1) * sl]).clone()
                  for a in _qkvw())
    for t in (q, k, v):
        t.requires_grad_(True)
    fn = F.ring_flash_attention if mode == "ring" else F.ulysses_attention
    out = fn(q, k, v, axis="sep", causal=causal)
    (out * w).sum().backward()
    return {"chunk": c, "out": out.detach().numpy(),
            "grads": [t.grad.numpy() for t in (q, k, v)]}


def _llama_case(root, name):
    """Step 1's loss and gradients, then the steps' losses and the
    parameters after them."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gather_jax_layout, load_jax_weights
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    mode, dp, sep = LLAMA[name]
    hcg = _init(root, dp, sep)
    model = models.LlamaForCausalLM(_llama_config(mode, models),
                                    device="cpu")
    with open(f"{root}/{name}.weights.pkl", "rb") as f:
        load_jax_weights(model, pickle.load(f))
    net = fleet.distributed_model(model)
    r, b = hcg.get_data_parallel_rank(), B // dp
    c, sl = hcg.get_sep_parallel_rank(), S // sep
    x, y = (torch.from_numpy(a[r * b:(r + 1) * b, c * sl:(c + 1) * sl])
            for a in _batch())
    opt = fleet.distributed_optimizer(AdamW(
        learning_rate=1e-3, weight_decay=0.01, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(1.0)))
    out = {"steps": []}
    for i in range(STEPS):
        loss = net(x, y)
        loss.backward()
        if i == 0:
            out["grads"] = gather_jax_layout(model, grads=True)
        opt.step()
        opt.clear_grad()
        out["steps"].append(float(loss))
    out["params"] = gather_jax_layout(model)
    return out


def _ulysses_errors(root):
    from paddle_tpu_torch.nn import functional as F

    _init(root, 1, 2)
    errors = []
    q = torch.zeros(1, 4, 4, 8)
    for k, qq in ((torch.zeros(1, 4, 2, 8), q),
                  (torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))):
        try:
            F.ulysses_attention(qq, k, k, axis="sep")
        except ValueError as e:
            errors.append(str(e))
    return errors


def _cp_worker(root, jobs):
    """One rank: each job ``(tag, kind, args)`` in turn, results pickled
    to ``root/{tag}.{rank}.pkl``."""
    _child_setup()
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(backend="gloo",
                           init_method=f"file://{root}/store")
    run = {"attn": _attention_case, "llama": _llama_case,
           "errors": _ulysses_errors}
    for tag, kind, args in jobs:
        out = run[kind](root, *args)
        with open(f"{root}/{tag}.{dist.get_rank()}.pkl", "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


# -- the reference ----------------------------------------------------------------


def _jax_init(dp, sep):
    from paddle_tpu.distributed import fleet as jfleet

    s = jfleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "sep_degree": sep}
    jfleet.init(is_collective=True, strategy=s)
    return jfleet


def _reference_attention(mode, sep, causal):
    """The function ``F.ring_flash_attention`` / ``F.ulysses_attention``
    build on the fleet mesh (``make_ring_attention`` /
    ``make_ulysses_attention``), on the global arrays, with
    ``jax.vjp``."""
    import jax
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.ops.ring_attention import make_ring_attention
    from paddle_tpu.ops.ulysses_attention import make_ulysses_attention

    _jax_init(1, sep)
    try:
        make = make_ring_attention if mode == "ring" \
            else make_ulysses_attention
        fn = make(jenv.ensure_env().mesh, axis="sep", causal=causal)
        q, k, v, w = _qkvw()
        out, vjp = jax.vjp(fn, q, k, v)
        return {"out": np.asarray(out),
                "grads": [np.asarray(g) for g in vjp(w)]}
    finally:
        jenv.reset_env()


def _reference_llama(name):
    import paddle_tpu as pt
    from paddle_tpu import models as jmodels
    from paddle_tpu.distributed import env as jenv

    mode, dp, sep = LLAMA[name]
    jfleet = _jax_init(dp, sep)
    try:
        pt.seed(11)
        jm = jmodels.LlamaForCausalLM(_llama_config(mode, jmodels))
        weights = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
        ids, labels = (pt.to_tensor(a) for a in _batch())
        net = jfleet.distributed_model(jm)
        opt = jfleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=1e-3, weight_decay=0.01,
            parameters=jm.parameters(),
            grad_clip=pt.nn.ClipGradByGlobalNorm(1.0)))
        ref = {"steps": []}
        for i in range(STEPS):
            loss = net(ids, labels)
            loss.backward()
            if i == 0:
                ref["grads"] = {n: np.asarray(p.grad.numpy())
                                for n, p in jm.named_parameters()}
            opt.step()
            opt.clear_grad()
            ref["steps"].append(float(loss.numpy()))
        ref["params"] = {n: np.asarray(p._data)
                         for n, p in jm.named_parameters()}
    finally:
        jenv.reset_env()
    return weights, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{tag: (reference, [each rank's results])}: the ranks of each world
    size spawned once."""
    root = tmp_path_factory.mktemp("context_parallel")
    refs, by_world = {}, {}
    for mode, sep, causal in ATTN_CASES:
        tag = f"attn_{mode}_{sep}_{causal}"
        refs[tag] = _reference_attention(mode, sep, causal)
        by_world.setdefault(sep, []).append(
            (tag, "attn", (mode, sep, causal)))
    weights = {}
    for name, (_, dp, sep) in LLAMA.items():
        weights[name], refs[name] = _reference_llama(name)
        by_world.setdefault(dp * sep, []).append((name, "llama", (name,)))
    by_world[2].append(("errors", "errors", ()))
    out = {}
    for world, jobs in sorted(by_world.items()):
        sub = root / f"w{world}"
        os.makedirs(sub)
        for name, w in weights.items():
            with open(sub / f"{name}.weights.pkl", "wb") as f:
                pickle.dump(w, f)
        spawn(_cp_worker, args=(str(sub), jobs), nprocs=world)
        for tag, _, _ in jobs:
            ranks = []
            for r in range(world):
                with open(sub / f"{tag}.{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            out[tag] = (refs.get(tag), ranks)
    return out


def _close(got, want, name, tol=TOL):
    """Within ``tol`` of the reference, relative to its largest value."""
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("mode,sep,causal", ATTN_CASES)
def test_attention_matches_reference(runs, mode, sep, causal):
    """The ranks' chunks of the output and of dq, dk, dv, put together
    along the sequence, against the reference's global arrays."""
    ref, ranks = runs[f"attn_{mode}_{sep}_{causal}"]
    ranks = sorted(ranks, key=lambda o: o["chunk"])
    _close(np.concatenate([o["out"] for o in ranks], 1), ref["out"], "out")
    for i, n in enumerate("qkv"):
        _close(np.concatenate([o["grads"][i] for o in ranks], 1),
               ref["grads"][i], f"d{n}")


@pytest.mark.parametrize("name", list(LLAMA))
def test_llama_loss_matches_reference_on_every_rank(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert abs(o["steps"][0] - ref["steps"][0]) <= TOL, \
            (o["steps"][0], ref["steps"][0])


@pytest.mark.parametrize("name", list(LLAMA))
def test_llama_every_gradient_matches_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        assert o["grads"].keys() == ref["grads"].keys()
        for n, g in o["grads"].items():
            _close(g, ref["grads"][n], n)


@pytest.mark.parametrize("name", list(LLAMA))
def test_llama_adamw_steps_match_reference(runs, name):
    ref, ranks = runs[name]
    for o in ranks:
        np.testing.assert_allclose(o["steps"], ref["steps"], atol=TOL,
                                   rtol=0)
        for n, p in o["params"].items():
            np.testing.assert_allclose(p, ref["params"][n], atol=PARAM_TOL,
                                       rtol=0, err_msg=n)


def test_ulysses_head_errors(runs):
    _, ranks = runs["errors"]
    for errors in ranks:
        assert len(errors) == 2, errors
        assert "equal q/k/v head counts (got 4/2/2)" in errors[0]
        assert "heads % axis degree == 0, got h=3 over sep=2" in errors[1]


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_degree_one_falls_back_bit_for_bit(mode):
    """Without a sep group both entries are the single-card attention,
    and the context-parallel Llama computes the plain one's numbers."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.nn import functional as F

    q, k, v, _ = (torch.from_numpy(a) for a in _qkvw())
    fn = F.ring_flash_attention if mode == "ring" else F.ulysses_attention
    for causal in (True, False):
        assert torch.equal(fn(q, k, v, causal=causal),
                           F.scaled_dot_product_attention(
                               q, k, v, is_causal=causal))
    ids, labels = (torch.from_numpy(a) for a in _batch())
    cp = models.LlamaForCausalLM(models.LlamaConfig.tiny(
        context_parallel=True, context_parallel_mode=mode), device="cpu")
    plain = models.LlamaForCausalLM(models.LlamaConfig.tiny(), device="cpu")
    losses = []
    for m in (cp, plain):
        loss = m(ids, labels)
        loss.backward()
        losses.append((loss, [p.grad for p in m.parameters()]))
    assert torch.equal(losses[0][0], losses[1][0])
    for a, b in zip(losses[0][1], losses[1][1]):
        assert torch.equal(a, b)
