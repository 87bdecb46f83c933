"""The port's ``amp`` held against the JAX package's on the CPU.

- every case of tests/test_amp.py mirrored on the port, each op's output
  dtype equal to the reference's (and the values equal, fp32 weights
  copied across): O1 white (linear), black (softmax) and gray (add)
  ops, O2 gray ops, ``enable=False``, custom lists, nesting, backward
  through a cast, bad arguments, ``decorate`` O2 and its fp32 masters,
  ``GradScaler`` (scale and step, a skipped step on overflow, growth
  after good steps, disabled pass-through, ``state_dict``) and a small
  network trained in bf16 O2 (60 Adam steps; the losses within 5e-2 of
  the reference's, bf16 arithmetic on both sides);
- the tiny Llama's loss and every gradient under ``auto_cast`` O1 in
  bfloat16 and in float16 against the JAX Llama under the same
  ``auto_cast`` (the same casts at the same ops: the loss within 2e-3 in
  bf16 and 5e-4 in fp16, each gradient within 4e-2 / 1e-2 of its largest
  value; the two frameworks round matmul outputs after summing in
  different orders), and the same losses finite in fp16 where the
  reference's are (its -1e30 fills stay finite);
- ``GradScaler`` trajectories: a model whose scaled gradients overflow
  at first, 8 steps with dynamic scaling, the scale after every step and
  which steps were skipped exactly equal to the reference's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import amp, tensor
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, load_jax_weights,
)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW


def _dt(x):
    """The dtype's name, either framework."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


def _linear_pair(i=8, o=8):
    jl = jnn.Linear(i, o)
    tl = Linear(i, o, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.numpy())))
        tl.bias.copy_(torch.from_numpy(np.array(jl.bias.numpy())))
    return jl, tl


def _x(shape, seed=0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return pt.to_tensor(x), torch.from_numpy(x)


def _same(jy, ty, atol=0.0):
    assert _dt(jy) == _dt(ty), (_dt(jy), _dt(ty))
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy.numpy(), np.float32),
                               rtol=0, atol=atol)


class TestAutoCast:
    def test_o1_white_op_low_precision(self):
        jx, tx = _x([4, 8])
        jl, tl = _linear_pair()
        with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
            jy = jl(jx)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            ty = tl(tx)
        assert ty.dtype == torch.bfloat16
        _same(jy, ty, atol=2e-2)

    def test_o1_black_op_fp32(self):
        jx, tx = _x([4, 8])
        with pt.amp.auto_cast(level="O1"):
            jy = pt.nn.functional.softmax(jx.astype("bfloat16"))
        with amp.auto_cast(level="O1"):
            ty = TF.softmax(tx.to(torch.bfloat16))
        assert ty.dtype == torch.float32
        _same(jy, ty, atol=1e-6)

    def test_o1_gray_op_keeps_dtype(self):
        jx, tx = _x([4])
        with pt.amp.auto_cast(level="O1"):
            jy = jx + jx
        with amp.auto_cast(level="O1"):
            ty = tensor.add(tx, tx)
        assert ty.dtype == torch.float32
        _same(jy, ty)

    def test_o1_gray_op_promotes_mixed_inputs(self):
        jx, tx = _x([4])
        with pt.amp.auto_cast(level="O1"):
            jy = jx + jx.astype("bfloat16")
        with amp.auto_cast(level="O1"):
            ty = tensor.add(tx, tx.to(torch.bfloat16))
        assert ty.dtype == torch.float32
        _same(jy, ty)

    def test_o2_gray_op_low_precision(self):
        jx, tx = _x([4])
        with pt.amp.auto_cast(level="O2"):
            jy = jx + jx
        with amp.auto_cast(level="O2"):
            ty = tensor.add(tx, tx)
        assert ty.dtype == torch.bfloat16
        _same(jy, ty)

    def test_disabled(self):
        jx, tx = _x([4, 8])
        jl, tl = _linear_pair()
        with pt.amp.auto_cast(enable=False):
            jy = jl(jx)
        with amp.auto_cast(enable=False):
            ty = tl(tx)
        assert ty.dtype == torch.float32
        _same(jy, ty, atol=1e-6)

    def test_custom_lists(self):
        jx, tx = _x([4, 8])
        jl, tl = _linear_pair()
        with pt.amp.auto_cast(custom_black_list={"linear", "matmul"}):
            jy = jl(jx)
        with amp.auto_cast(custom_black_list={"linear", "matmul"}):
            ty = tl(tx)
        assert ty.dtype == torch.float32
        _same(jy, ty, atol=1e-6)
        with amp.auto_cast(custom_white_list={"softmax"}):
            assert TF.softmax(tx).dtype == torch.bfloat16
            assert tensor.matmul(tx, tx.t()).dtype == torch.bfloat16

    def test_nested_restores(self):
        jx, tx = _x([2, 2])
        with pt.amp.auto_cast(level="O2"), amp.auto_cast(level="O2"):
            with pt.amp.auto_cast(enable=False), \
                    amp.auto_cast(enable=False):
                _same(jx + jx, tensor.add(tx, tx))
                assert tensor.add(tx, tx).dtype == torch.float32
            _same(jx + jx, tensor.add(tx, tx))
            assert tensor.add(tx, tx).dtype == torch.bfloat16
            assert amp.amp_state().level == "O2"
        assert tensor.add(tx, tx).dtype == torch.float32
        assert amp.amp_state() is None

    def test_backward_through_amp(self):
        jx, tx = _x([2, 8])
        jl, tl = _linear_pair(8, 4)
        with pt.amp.auto_cast(level="O1"):
            jloss = jl(jx).sum()
        jloss.backward()
        with amp.auto_cast(level="O1"):
            tloss = tl(tx).sum()
        tloss.backward()
        assert tl.weight.grad is not None
        assert tuple(tl.weight.grad.shape) == tuple(jl.weight.grad.shape)
        assert tl.weight.grad.dtype == torch.float32
        np.testing.assert_allclose(tl.weight.grad.numpy(),
                                   jl.weight.grad.numpy(), atol=2e-2)

    def test_bad_args(self):
        with pytest.raises(ValueError):
            with amp.auto_cast(dtype="float8"):
                pass
        with pytest.raises(ValueError):
            with amp.auto_cast(level="O9"):
                pass

    def test_support_queries(self):
        assert amp.is_bfloat16_supported() == pt.amp.is_bfloat16_supported()
        assert amp.is_float16_supported() == pt.amp.is_float16_supported()
        assert amp.WHITE_LIST == pt.amp.WHITE_LIST
        assert amp.BLACK_LIST == pt.amp.BLACK_LIST


class TestDecorate:
    def test_o2_casts_params(self):
        _, tl = _linear_pair(4, 4)
        opt = AdamW(parameters=tl.parameters())
        tl, opt = amp.decorate(tl, opt, level="O2")
        assert tl.weight.dtype == torch.bfloat16
        assert opt._multi_precision

    def test_o1_keeps_params_and_float16(self):
        _, tl = _linear_pair(4, 4)
        opt = AdamW(parameters=tl.parameters())
        tl, opt = amp.decorate(tl, opt, level="O1", dtype="float16")
        assert tl.weight.dtype == torch.float32 and opt._multi_precision
        tl = amp.decorate(tl, level="O2", dtype="float16")
        assert tl.weight.dtype == torch.float16

    def test_o2_training_keeps_master_weights(self):
        _, tl = _linear_pair(4, 4)
        opt = SGD(learning_rate=0.1, parameters=tl.parameters())
        tl, opt = amp.decorate(tl, opt, level="O2")
        _, x = _x([8, 4])
        with amp.auto_cast(level="O2"):
            loss = tl(x).sum()
        loss.backward()
        opt.step()
        assert len(opt._master_weights) == 2
        for mw in opt._master_weights.values():
            assert mw.dtype == torch.float32


def _scaler_pair(**kw):
    return pt.amp.GradScaler(**kw), amp.GradScaler(**kw)


class TestGradScaler:
    def test_scale_and_step(self):
        jl, tl = _linear_pair(4, 4)
        jopt = pt.optimizer.SGD(learning_rate=0.01,
                                parameters=jl.parameters())
        topt = SGD(learning_rate=0.01, parameters=tl.parameters())
        js, ts = _scaler_pair(init_loss_scaling=1024.0)
        jx, tx = _x([8, 4])
        w0 = tl.weight.detach().clone()
        js.scale(jl(jx).sum()).backward()
        js.step(jopt)
        js.update()
        ts.scale(tl(tx).sum()).backward()
        ts.step(topt)
        ts.update()
        assert not torch.equal(tl.weight, w0)
        # the gradients were unscaled before the step
        np.testing.assert_allclose(tl.weight.detach().numpy(),
                                   jl.weight.numpy(), atol=1e-6)

    def test_skip_on_overflow_and_scale_decrease(self):
        _, tl = _linear_pair(2, 2)
        opt = SGD(learning_rate=0.1, parameters=tl.parameters())
        scaler = amp.GradScaler(init_loss_scaling=8.0,
                                decr_every_n_nan_or_inf=1)
        w0 = tl.weight.detach().clone()
        x = torch.tensor([[np.inf, 1.0]])
        scaler.scale(tl(x).sum()).backward()
        scaler.step(opt)  # must skip
        scaler.update()
        assert torch.equal(tl.weight, w0)
        assert scaler.get_loss_scaling() == 4.0

    def test_scale_increase_after_good_steps(self):
        _, tl = _linear_pair(2, 2)
        opt = SGD(parameters=tl.parameters())
        scaler = amp.GradScaler(init_loss_scaling=8.0, incr_every_n_steps=2)
        _, x = _x([4, 2])
        for _ in range(2):
            scaler.scale(tl(x).sum()).backward()
            scaler.step(opt)
            scaler.update()
            opt.clear_grad()
        assert scaler.get_loss_scaling() == 16.0

    def test_disabled_scaler_passthrough(self):
        scaler = amp.GradScaler(enable=False)
        x = torch.tensor([3.0])
        assert scaler.scale(x) is x

    def test_state_dict_roundtrip(self):
        js, ts = _scaler_pair(init_loss_scaling=4.0)
        ts._good_steps = js._good_steps = 7
        assert ts.state_dict() == js.state_dict()
        s2 = amp.GradScaler()
        s2.load_state_dict(ts.state_dict())
        assert s2.get_loss_scaling() == 4.0
        assert s2._good_steps == 7

    def test_trajectory_matches_reference(self):
        """Scaled gradients overflow fp32 at first: the scale halves on
        every skipped step, then doubles after two good ones."""
        jl, tl = _linear_pair(4, 3)
        jopt = pt.optimizer.SGD(learning_rate=0.01,
                                parameters=jl.parameters())
        topt = SGD(learning_rate=0.01, parameters=tl.parameters())
        kw = dict(init_loss_scaling=2.0 ** 127, incr_every_n_steps=2,
                  decr_every_n_nan_or_inf=1)
        js, ts = _scaler_pair(**kw)
        traj = ([], [])
        for i in range(8):
            jx, tx = _x([6, 4], seed=i)
            jw = jl.weight.numpy().copy()
            tw = tl.weight.detach().clone()
            js.minimize(jopt, js.scale((jl(jx) * 10.0).sum()))
            jopt.clear_grad()
            ts.minimize(topt, ts.scale((tl(tx) * 10.0).sum()))
            topt.clear_grad()
            traj[0].append((js.get_loss_scaling(),
                            bool(np.array_equal(jw, jl.weight.numpy()))))
            traj[1].append((ts.get_loss_scaling(),
                            bool(torch.equal(tw, tl.weight))))
        assert traj[0] == traj[1]
        assert any(skip for _, skip in traj[1])
        assert not all(skip for _, skip in traj[1])
        np.testing.assert_allclose(tl.weight.detach().numpy(),
                                   jl.weight.numpy(), atol=1e-5)


class TestAmpTraining:
    def test_bf16_o2_converges(self):
        jl1, tl1 = _linear_pair(4, 32)
        jl2, tl2 = _linear_pair(32, 1)
        jnet = jnn.Sequential(jl1, jnn.ReLU(), jl2)
        tnet = torch.nn.Sequential(tl1, torch.nn.ReLU(), tl2)
        jopt = pt.optimizer.Adam(learning_rate=0.01,
                                 parameters=jnet.parameters())
        topt = Adam(learning_rate=0.01, parameters=tnet.parameters())
        jnet, jopt = pt.amp.decorate(jnet, jopt, level="O2")
        tnet, topt = amp.decorate(tnet, topt, level="O2")
        rng = np.random.RandomState(0)
        losses = ([], [])
        for _ in range(60):
            xb = rng.randn(16, 4).astype("float32")
            yb = xb.sum(axis=1, keepdims=True) * 0.5
            with pt.amp.auto_cast(level="O2"):
                pred = jnet(pt.to_tensor(xb))
                jloss = ((pred.astype("float32") - pt.to_tensor(yb)) ** 2
                         ).mean()
            jloss.backward()
            jopt.step()
            jopt.clear_grad()
            with amp.auto_cast(level="O2"):
                pred = tnet(torch.from_numpy(xb))
                assert pred.dtype == torch.bfloat16
                tloss = ((pred.float() - torch.from_numpy(yb)) ** 2).mean()
            tloss.backward()
            topt.step()
            topt.clear_grad()
            losses[0].append(float(jloss.numpy()))
            losses[1].append(float(tloss.detach()))
        assert losses[1][-1] < losses[1][0] * 0.2, losses[1]
        np.testing.assert_allclose(losses[1], losses[0], rtol=5e-2,
                                   atol=5e-2)


def _llama_pair():
    pt.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                          device="cpu")
    load_jax_weights(tm, {n: np.asarray(p._data)
                          for n, p in jm.named_parameters()})
    return jm, tm


@pytest.mark.parametrize("dtype, loss_tol, grad_tol",
                         [("bfloat16", 2e-3, 4e-2), ("float16", 5e-4, 1e-2)])
def test_llama_o1_loss_and_grads_match_reference(dtype, loss_tol, grad_tol):
    jm, tm = _llama_pair()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels[0, :3] = -100
    with pt.amp.auto_cast(level="O1", dtype=dtype):
        jl = jm(pt.to_tensor(ids), pt.to_tensor(labels))
    jl.backward()
    with amp.auto_cast(level="O1", dtype=dtype):
        tl = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    jv, tv = float(jl.numpy()), float(tl)
    assert np.isfinite(tv) and np.isfinite(jv)
    assert abs(tv - jv) < loss_tol, (tv, jv)
    assert tl.dtype == torch.float32
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32, n
        scale = np.abs(jg[n]).max() + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, jg[n] / scale,
                                   rtol=0, atol=grad_tol, err_msg=n)
