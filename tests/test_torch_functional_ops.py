"""The port's ``nn.functional`` held against the reference beyond the op
specs, with the same numpy inputs.

- ``ROWS`` (``tests/torch_functional_cases.py``, free of JAX so that
  ``chip_smoke.py`` phase 24 runs the same rows on the card): every
  function the sweep does not reach and every option of the repaired
  and new functions, forward (dtype names, shapes, ints and bools equal,
  floats within the row's ``tol`` of the largest magnitude) and, for the
  inputs a row names, the gradient of ``sum(out * cotangent)`` from
  ``torch.autograd`` against the reference's ``backward()``.
- C.9: ``F.dropout`` with the reference's positional order, ``axis``
  and ``downscale_in_infer``, by statistics and structure (the masks
  come from different generators); C.10's options are rows.
- the random functions: seed, draw count, moments within 6 standard
  errors; ``class_center_sample`` by its invariants.
- ``return_mask``: the first maximum in window order, spelled out; the
  adaptive pools' masks (which the reference ignores) by the same rule.
- the layers over the repaired functions, the refusals, ``auto_cast``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.framework.device import using_device
from torch_functional_cases import (
    _SELU_AP, RANDOM, ROWS, SIGMAS, TIES, TIES1, TIES3, alpha_coefs, draw,
    flat, port_grads, reference_grads,
)

JF = pt.nn.functional


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _port_tensor(a):
    return ptt.to_tensor(np.array(a), place="cpu")


def _ref_tensor(a):
    return pt.to_tensor(np.array(a))


def _close(got, want, tol, what):
    """``got`` within ``tol`` of ``want``'s largest magnitude (ints and
    bools equal; non-finite entries in the same places)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    scale = scale if scale > 0 else 1.0
    np.testing.assert_allclose(got[fin] / scale, want[fin] / scale,
                               atol=tol, rtol=0, err_msg=what)


def _same(got, want, tol, what):
    got, want = flat(got), flat(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for g, w in zip(got, want):
        if not isinstance(w, pt.Tensor):
            assert g == w, (what, g, w)
            continue
        assert isinstance(g, torch.Tensor), (what, type(g))
        wn = np.asarray(w.numpy())
        assert str(g.dtype).replace("torch.", "") == wn.dtype.name, \
            (what, g.dtype, wn.dtype)
        _close(g.detach().numpy(), wn, tol, what)


@pytest.fixture
def _no_auto_mesh():
    """Tear down the mesh that the reference's ring and Ulysses entries
    make at degree 1 (``ensure_env``), so it cannot reach the next
    row."""
    yield
    from paddle_tpu.distributed import env

    e = env.get_env()
    if e is not None and getattr(e, "auto_initialized", False):
        env.reset_env()


@pytest.mark.parametrize("row", ROWS, ids=[r.id for r in ROWS])
def test_row_matches_reference(row, _no_auto_mesh):
    want = row.call(JF, *[_ref_tensor(a) for a in row.inputs])
    got = row.call(TF, *[_port_tensor(a) for a in row.inputs])
    _same(got, want, row.tol, row.id)
    if row.grad:
        ref = reference_grads(pt, lambda *xs: row.call(JF, *xs), row.inputs,
                              row.grad)
        port = port_grads(lambda *xs: row.call(TF, *xs), row.inputs,
                          row.grad)
        for i, g, w in zip(row.grad, port, ref):
            _close(g, w, row.tol, f"{row.id} d/d input {i}")


# -- C.9: dropout -------------------------------------------------------------


def _share_zero(out):
    return float((np.asarray(out) == 0).mean())


def _within(share, p, n, what):
    se = np.sqrt(p * (1 - p) / n)
    assert abs(share - p) < SIGMAS * se, (what, share, p)


def test_dropout_positional_order_drops():
    """``F.dropout(x, 0.5, None)``: ``None`` is ``axis``, so training
    stays on and half the elements drop in both packages (the port
    skipped dropout here before: ``training`` took the None)."""
    x = np.ones((400, 60), np.float32)
    ptt.seed(1)
    got = TF.dropout(_port_tensor(x), 0.5, None).numpy()
    want = np.asarray(JF.dropout(_ref_tensor(x), 0.5, None).numpy())
    for out in (got, want):
        _within(_share_zero(out), 0.5, x.size, "positional")
        assert set(np.unique(out)) <= {0.0, 2.0}
    # a positional axis and training: axis 0, eval -> the identity
    assert np.array_equal(TF.dropout(_port_tensor(x), 0.5, 0, False).numpy(),
                          x)


@pytest.mark.parametrize("axis", [0, [0, 2], [2, 1]])
def test_dropout_axis_drops_whole_slices(axis):
    """One draw per index of ``axis``, broadcast over the other dims:
    each slice is all kept (scaled) or all zero, in both packages, with
    the share of dropped slices within 6 standard errors."""
    x = np.ones((300, 5, 40), np.float32)
    axes = [axis] if isinstance(axis, int) else axis
    other = tuple(d for d in range(3) if d not in axes)
    for out in (TF.dropout(_port_tensor(x), 0.3, axis).numpy(),
                np.asarray(JF.dropout(_ref_tensor(x), 0.3, axis).numpy())):
        zero = out == 0
        assert (zero.all(other) | ~zero.any(other)).all()
        kept = out[~zero]
        np.testing.assert_allclose(kept, 1 / 0.7, rtol=1e-6)
        n = int(np.prod([x.shape[d] for d in axes]))
        _within(float(zero.all(other).mean()), 0.3, n, f"axis {axis}")


def test_dropout_downscale_in_infer():
    """Training keeps the kept values unscaled; eval multiplies by ``1 -
    p``, equal to the reference's."""
    x = np.random.RandomState(0).uniform(0.5, 1.5, (200, 100)).astype(
        np.float32)
    for out in (TF.dropout(_port_tensor(x), 0.2, mode="downscale_in_infer")
                .numpy(),
                np.asarray(JF.dropout(_ref_tensor(x), 0.2,
                                      mode="downscale_in_infer").numpy())):
        kept = out != 0
        np.testing.assert_array_equal(out[kept], x[kept])
        _within(1 - float(kept.mean()), 0.2, x.size, "downscale")
    got = TF.dropout(_port_tensor(x), 0.2, training=False,
                     mode="downscale_in_infer").numpy()
    want = JF.dropout(_ref_tensor(x), 0.2, training=False,
                      mode="downscale_in_infer").numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="mode"):
        TF.dropout(_port_tensor(x), 0.2, mode="other")


def test_dropout_layers_pass_every_argument():
    """``nn.Dropout(p, axis, mode)`` and the tracker's ``dropout`` reach
    the repaired function: whole columns drop, eval downscales."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import random as prand

    x = _port_tensor(np.ones((64, 500), np.float32))
    d = tnn.Dropout(0.4, axis=1, mode="downscale_in_infer")
    y = d(x).numpy()
    assert set(np.unique(y)) <= {0.0, 1.0}
    assert (y == y[:1]).all()
    d.eval()
    np.testing.assert_allclose(d(x).numpy(), 0.6)
    want = pt.nn.Dropout(0.4, axis=1, mode="downscale_in_infer")
    want.eval()
    np.testing.assert_allclose(
        np.asarray(want(_ref_tensor(np.ones((64, 500), np.float32)))
                   .numpy()), 0.6)
    prand.model_parallel_random_seed(3)
    z = prand.dropout(x, 0.5, axis=0).numpy()
    assert (z == z[:, :1]).all()


# -- C.10: the layer ----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(weight=True, ignore_index=1), dict(soft_label=True),
    dict(label_smoothing=0.1, reduction="sum"), dict(axis=0),
    dict(use_softmax=False, reduction="none")], ids=str)
def test_cross_entropy_loss_layer_passes_every_argument(kw):
    r = np.random.RandomState(14)
    logits = r.uniform(0.05, 1, (6, 10)).astype(np.float32)
    labels = r.randint(0, 10, (6, 1)).astype(np.int64)
    if kw.get("soft_label"):
        labels = r.dirichlet(np.ones(10), 6).astype(np.float32)
    if kw.get("axis") == 0:
        logits, labels = logits.T.copy(), labels.T.copy()
    w = r.uniform(0.5, 2, 10).astype(np.float32)
    jkw = dict(kw, weight=_ref_tensor(w)) if kw.get("weight") else kw
    tkw = dict(kw, weight=_port_tensor(w)) if kw.get("weight") else kw
    want = pt.nn.CrossEntropyLoss(**jkw)(_ref_tensor(logits),
                                         _ref_tensor(labels))
    got = tnn.CrossEntropyLoss(**tkw)(_port_tensor(logits),
                                      _port_tensor(labels))
    _same(got, want, 1e-5, str(kw))


def test_cross_entropy_positional_weight_and_sum():
    """The probe of C.10: a positional class weight and ``"sum"``."""
    r = np.random.RandomState(2)
    x, y = r.randn(5, 3).astype(np.float32), r.randint(0, 3, 5)
    w = np.array([0.5, 1.0, 2.0], np.float32)
    for args, kw in ((((w,)), {}), ((), dict(reduction="sum"))):
        want = JF.cross_entropy(_ref_tensor(x), _ref_tensor(y),
                                *[_ref_tensor(a) for a in args], **kw)
        got = TF.cross_entropy(_port_tensor(x), _port_tensor(y),
                               *[_port_tensor(a) for a in args], **kw)
        _same(got, want, 1e-6, str(kw))


# -- the random functions -----------------------------------------------------


@pytest.mark.parametrize("name", RANDOM)
def test_random_moments_seed_and_draw_count(name):
    fn, samples, mean, se = draw(TF, name)
    ptt.seed(5)
    before = trandom.draws()
    a = fn()
    assert trandom.draws() == before + 1, "a draw must count itself"
    ptt.seed(5)
    b = fn()
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x, y), "one seed must give one draw"
    s = samples(a).double()
    assert abs(float(s.mean()) - mean) < SIGMAS * se, \
        (name, float(s.mean()), mean, se)


def test_random_structure():
    """dropout2d/3d drop whole channels; alpha_dropout takes the
    reference's two values; gumbel_softmax(hard) is one-hot forward and
    soft backward; rrelu's slopes lie in [lower, upper)."""
    ptt.seed(2)
    x = torch.ones(64, 8, 3, 5)
    y = TF.dropout2d(x, 0.5)
    assert (y == y[:, :, :1, :1]).all()
    y = TF.dropout3d(torch.ones(16, 8, 2, 3, 4, requires_grad=True), 0.5,
                     data_format="NDHWC")
    assert (y == y[:, :1, :1, :1, :]).all()
    a, b = alpha_coefs(0.3)
    out = np.unique(TF.alpha_dropout(torch.zeros(5000), 0.3).numpy())
    ref = np.unique(np.asarray(JF.alpha_dropout(
        _ref_tensor(np.zeros(5000, np.float32)), 0.3).numpy()))
    assert out.shape == ref.shape == (2,)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_allclose(np.sort([b, b + a * _SELU_AP]), out,
                               rtol=1e-6)
    z = torch.randn(50, 6, requires_grad=True)
    g = TF.gumbel_softmax(z, 0.5, hard=True)
    assert (g.sum(-1) == 1).all() and set(g.unique().tolist()) == {0.0, 1.0}
    (g * torch.arange(6.0)).sum().backward()
    assert z.grad.abs().sum() > 0
    s = -TF.rrelu(-torch.ones(10000), 0.2, 0.25)
    assert float(s.min()) >= 0.2 and float(s.max()) < 0.25


def test_class_center_sample_invariants():
    """Every positive class is sampled; the set is sorted, unique, of
    size ``num_samples``; the remapped labels index it; a seed repeats;
    the reference's set obeys the same (its draw is JAX's)."""
    label = np.array([[3, 17], [3, 40], [99, 0]], np.int64)
    ptt.seed(4)
    remap, sampled = TF.class_center_sample(_port_tensor(label), 100, 12)
    ptt.seed(4)
    remap2, sampled2 = TF.class_center_sample(_port_tensor(label), 100, 12)
    assert torch.equal(sampled, sampled2) and torch.equal(remap, remap2)
    jremap, jsampled = JF.class_center_sample(_ref_tensor(label), 100, 12)
    for r, s in ((remap.numpy(), sampled.numpy()),
                 (np.asarray(jremap.numpy()), np.asarray(jsampled.numpy()))):
        assert s.shape == (12,) and (np.diff(s) > 0).all()
        assert set(label.ravel()) <= set(s.tolist())
        np.testing.assert_array_equal(s[r], label)
    assert remap.dtype == torch.int32 and sampled.dtype == torch.int32
    with pytest.raises(ValueError, match="smaller"):
        TF.class_center_sample(_port_tensor(label), 100, 3)


# -- max-pool indices ---------------------------------------------------------


def _first_max_model(a, k, s):
    """The pooled maxima and their flat indices by a loop: each
    window's first maximum in row-major window order."""
    n, c = a.shape[:2]
    sp = a.shape[2:]
    outs = [(sp[d] - k[d]) // s[d] + 1 for d in range(len(sp))]
    val = np.zeros((n, c) + tuple(outs), a.dtype)
    idx = np.zeros((n, c) + tuple(outs), np.int64)
    for o in np.ndindex(*outs):
        best = None
        for w in np.ndindex(*k):
            pos = tuple(o[d] * s[d] + w[d] for d in range(len(sp)))
            v = a[(slice(None), slice(None)) + pos]
            flat_pos = np.ravel_multi_index(pos, sp)
            if best is None:
                best = v.copy()
                bidx = np.full(v.shape, flat_pos)
            else:
                better = v > best
                best = np.where(better, v, best)
                bidx = np.where(better, flat_pos, bidx)
        val[(slice(None), slice(None)) + o] = best
        idx[(slice(None), slice(None)) + o] = bidx
    return val, idx


@pytest.mark.parametrize("a,k,s,fn", [
    (TIES1, (3,), (2,), "max_pool1d"), (TIES, (2, 3), (2, 1), "max_pool2d"),
    (TIES3, (2, 2, 3), (1, 2, 2), "max_pool3d")],
    ids=["1d", "2d", "3d"])
def test_return_mask_takes_the_first_maximum(a, k, s, fn):
    val, idx = getattr(TF, fn)(_port_tensor(a), list(k), list(s),
                               return_mask=True)
    want_val, want_idx = _first_max_model(a, k, s)
    np.testing.assert_array_equal(val.numpy(), want_val)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert idx.dtype == torch.int32


def test_adaptive_max_pool_mask():
    """The reference ignores ``return_mask`` here and returns the pooled
    tensor alone; the port returns its indices too, by the same first
    maximum rule: uneven windows [floor(i n / o), ceil((i + 1) n / o))
    pooled by a loop."""
    a = TIES
    val, idx = TF.adaptive_max_pool2d(_port_tensor(a), [4, 3],
                                      return_mask=True)
    want = np.asarray(JF.adaptive_max_pool2d(_ref_tensor(a), [4, 3],
                                             return_mask=True).numpy())
    np.testing.assert_array_equal(val.numpy(), want)
    h, w = a.shape[2:]
    for i in range(4):
        for j in range(3):
            r0, r1 = i * h // 4, -(-(i + 1) * h // 4)
            c0, c1 = j * w // 3, -(-(j + 1) * w // 3)
            win = a[:, :, r0:r1, c0:c1].reshape(2, 3, -1)
            first = win.argmax(-1)
            rows, cols = np.unravel_index(first, (r1 - r0, c1 - c0))
            np.testing.assert_array_equal(idx[:, :, i, j].numpy(),
                                          (rows + r0) * w + cols + c0)
    v1, i1 = TF.adaptive_max_pool1d(_port_tensor(TIES1), 4, True)
    v3, i3 = TF.adaptive_max_pool3d(_port_tensor(TIES3), [2, 3, 4], True)
    for v, i, src in ((v1, i1, TIES1), (v3, i3, TIES3)):
        flat_src = src.reshape(src.shape[0], src.shape[1], -1)
        np.testing.assert_array_equal(
            np.take_along_axis(flat_src, i.numpy().reshape(
                i.shape[0], i.shape[1], -1), -1).reshape(v.shape),
            v.numpy())


def test_max_unpool_inverts_the_mask():
    """Pooled values scattered back by their indices: the max positions
    hold the maxima, the rest zeros, as the reference's."""
    x = np.random.RandomState(1).randn(2, 3, 6, 8).astype(np.float32)
    for m, f, r in ((TF, _port_tensor, lambda t: t.numpy()),
                    (JF, _ref_tensor, lambda t: np.asarray(t.numpy()))):
        val, idx = m.max_pool2d(f(x), 2, return_mask=True)
        out = r(m.max_unpool2d(val, idx, 2))
        if m is TF:
            got = out
        else:
            np.testing.assert_array_equal(got, out)
    assert (got != 0).sum() == 2 * 3 * 3 * 4


# -- refusals, auto_cast, apply -----------------------------------------------


def test_refusals():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError, match="bilinearly"):
        TF.grid_sample(x, torch.zeros(1, 2, 2, 2), mode="nearest")
    with pytest.raises(NotImplementedError, match="bilinearly"):
        TF.grid_sample(x, torch.zeros(1, 2, 2, 2), padding_mode="border")
    with pytest.raises(NotImplementedError, match="SAME"):
        TF.conv2d_transpose(x, torch.zeros(1, 1, 2, 2), padding="SAME")

    class Two:  # not a distributed.Group: the class-sharded form needs one
        nranks = 2  # (its parity: tests/test_torch_margin_ce_sampler.py)
    with pytest.raises(TypeError, match="distributed.Group"):
        TF.margin_cross_entropy(torch.zeros(2, 3), torch.zeros(2), group=Two())
    with pytest.raises(ValueError, match="NCHW"):
        TF.max_pool2d(torch.zeros(1, 4, 4, 1), 2, return_mask=True,
                      data_format="NHWC")


def test_huber_loss_reduces():
    """The reference's ``huber_loss`` hands its result to ``jnp.mean``
    as a Tensor and raises for ``"mean"`` and ``"sum"`` (ROADMAP C); the
    port reduces the elementwise loss that the reference's ``"none"``
    gives."""
    a, b = (np.random.RandomState(i).randn(3, 4).astype(np.float32)
            for i in (0, 1))
    per = np.asarray(JF.huber_loss(_ref_tensor(a), _ref_tensor(b),
                                   reduction="none").numpy())
    with pytest.raises(TypeError):
        JF.huber_loss(_ref_tensor(a), _ref_tensor(b))
    np.testing.assert_allclose(
        TF.huber_loss(_port_tensor(a), _port_tensor(b)).numpy(), per.mean(),
        rtol=1e-6)
    np.testing.assert_allclose(
        TF.huber_loss(_port_tensor(a), _port_tensor(b), reduction="sum")
        .numpy(), per.sum(), rtol=1e-6)


@pytest.mark.parametrize("call", [
    lambda F, x, w: F.conv2d_transpose(x, w),
    lambda F, x, w: F.log_softmax(x),
    lambda F, x, w: F.group_norm(x, 2),
    lambda F, x, w: F.interpolate(x, scale_factor=2, mode="bilinear"),
    lambda F, x, w: F.apply("linear", lambda a, b: a, (x, w)),
], ids=["white", "black", "black_norm", "gray", "apply"])
def test_auto_cast_dtypes(call):
    """Under O1 bf16 the output dtype is the reference's: white ops in
    bf16, black ops in fp32, gray ops keep fp32."""
    x = np.random.RandomState(0).randn(1, 2, 4, 4).astype(np.float32)
    w = np.random.RandomState(1).randn(2, 3, 2, 2).astype(np.float32)
    with pt.amp.auto_cast(dtype="bfloat16"):
        want = call(JF, _ref_tensor(x), _ref_tensor(w))
    with tamp.auto_cast(dtype="bfloat16"):
        got = call(TF, _port_tensor(x), _port_tensor(w))
    assert str(got.dtype).replace("torch.", "") == \
        np.asarray(want.numpy()).dtype.name
