"""The port's ``autograd`` (``PyLayer``, ``grad``, the grad switches,
``backward``, ``saved_tensors_hooks``, the functional derivatives) and
``incubate.autograd`` held against the reference's on the CPU at 1e-5,
from numpy inputs made from a seed.

The cases of ``tests/test_pylayer_functional.py`` run in both packages:
a custom forward and backward, a backward of the wrong shape, several
outputs and a ``PyLayer`` inside a trained layer, then ``vjp``, ``jvp``,
``jacobian``, ``hessian``, ``vhp`` and ``Jacobian``'s indexing, with one
input and with two. A function under test is written once over a
package (``P``) and called with each.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.autograd import PyLayer as JPyLayer
from paddle_tpu.incubate import autograd as jinc
from paddle_tpu_torch.autograd import PyLayer as TPyLayer
from paddle_tpu_torch.framework.device import using_device
from paddle_tpu_torch.incubate import autograd as tinc

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with using_device("cpu"):
        yield


def _arr(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jt(a, grad=True):
    return jp.to_tensor(a, stop_gradient=not grad)


def _tt(a, grad=True):
    return torch.tensor(a, requires_grad=grad)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy())


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cube(base):
    class Cube(base):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, grad):
            (x,) = ctx.saved_tensor()
            return grad * 3.0 * x * x

    return Cube


def test_pylayer_custom_forward_backward():
    a = _arr(5)
    jx, tx = _jt(a), _tt(a)
    jy, ty = _cube(JPyLayer).apply(jx), _cube(TPyLayer).apply(tx)
    _close(ty, jy)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    _close(tx.grad, jx.grad)


def test_pylayer_user_rule_wins_and_wrong_shape_raises():
    def bad(base, P, shape=None):
        class Bad(base):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, grad):
                # the user's rule: d/dx = 1 (a wrong value, the right shape)
                return grad if shape is None else P.ones(shape)

        return Bad

    a = _arr(3)
    jx, tx = _jt(a), _tt(a)
    bad(JPyLayer, jp).apply(jx).sum().backward()
    bad(TPyLayer, tp).apply(tx).sum().backward()
    _close(tx.grad, jx.grad)
    np.testing.assert_array_equal(_np(tx.grad), np.ones(3))
    # a gradient of the wrong shape: the reference stores it, the port
    # raises naming the layer and both shapes
    jx = _jt(a)
    bad(JPyLayer, jp, [2]).apply(jx).sum().backward()
    assert list(jx.grad.shape) == [2]
    with pytest.raises(RuntimeError, match=r"Bad.backward returned a "
                       r"gradient of shape \[2\] for input 0 of shape \[3\]"):
        bad(TPyLayer, tp, [2]).apply(_tt(a)).sum().backward()


def test_pylayer_several_outputs_and_needs_input_grad():
    needs = []

    def split(base):
        class Split2(base):
            @staticmethod
            def forward(ctx, x, y, scale=1.0):
                ctx.scale = scale
                needs.append(tuple(ctx.needs_input_grad))
                return x * 2 * scale, x * y * 3

            @staticmethod
            def backward(ctx, g1, g2):
                return g1 * 2 * ctx.scale, None

        return Split2

    a, b = _arr(4), _arr(4, seed=1)
    outs = {}
    for name, base, mk in (("j", JPyLayer, _jt), ("t", TPyLayer, _tt)):
        x, y = mk(a), mk(b, grad=False)
        fn = split(base)
        p, q = fn.apply(x, y, scale=0.5)
        (p.sum() + (q * q).sum()).backward()
        outs[name] = (p, q, x.grad)
    assert needs == [(True, False)] * 2
    for got, want in zip(outs["t"], outs["j"]):
        _close(got, want)


def test_pylayer_inside_a_trained_layer():
    def scaled_relu(base, P):
        class ScaledReLU(base):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return P.maximum(x, P.zeros_like(x)) * 2

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensor()
                return g * (x > 0).astype("float32") * 2 \
                    if base is JPyLayer else g * (x > 0).float() * 2

        return ScaledReLU

    w, b, x = _arr(4, 4), _arr(4, seed=1), _arr(6, 4, seed=2)
    jlin, tlin = jp.nn.Linear(4, 4), tp.nn.Linear(4, 4)
    jlin.weight.set_value(w)
    jlin.bias.set_value(b)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(w))
        tlin.bias.copy_(torch.from_numpy(b))
    jy = scaled_relu(JPyLayer, jp).apply(jlin(_jt(x, False)))
    ty = scaled_relu(TPyLayer, tp).apply(tlin(_tt(x, False)))
    _close(ty, jy)
    jy.mean().backward()
    ty.mean().backward()
    _close(tlin.weight.grad, jlin.weight.grad)
    _close(tlin.bias.grad, jlin.bias.grad)


# -- the functional derivatives ---------------------------------------------

def _f1(P):
    return lambda x: (P.tanh(x) * x ** 3).sum()


def _f_vec(P):
    return lambda x: P.sin(x) * x


def _f2(P):
    return lambda x, y: (P.exp(x * 0.3) * y + x * y * y).sum()


def _f2_vec(P):
    return lambda x, y: P.tanh(x) * y * 2.0


def _close_tree(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w)
    else:
        _close(got, want)


def test_vjp_one_and_two_inputs():
    a, b, v = _arr(5), _arr(5, seed=1), _arr(5, seed=2)
    _close_tree(tp.autograd.vjp(_f1(tp), torch.tensor(a)),
                jp.autograd.vjp(_f1(jp), jp.to_tensor(a)))
    j = jp.autograd.vjp(_f2_vec(jp), [jp.to_tensor(a), jp.to_tensor(b)],
                        jp.to_tensor(v))
    t = tp.autograd.vjp(_f2_vec(tp), [torch.tensor(a), torch.tensor(b)],
                        torch.tensor(v))
    assert isinstance(t[1], list) and len(t[1]) == 2
    _close_tree(t, j)


def test_jvp_one_and_two_inputs():
    a, b, v, w = (_arr(5, seed=s) for s in range(4))
    j = jp.autograd.jvp(_f_vec(jp), jp.to_tensor(a), jp.to_tensor(v))
    t = tp.autograd.jvp(_f_vec(tp), torch.tensor(a), torch.tensor(v))
    _close_tree(t, j)
    j = jp.autograd.jvp(_f2_vec(jp), [jp.to_tensor(a), jp.to_tensor(b)])
    t = tp.autograd.jvp(_f2_vec(tp), [torch.tensor(a), torch.tensor(b)])
    _close_tree(t, j)


def test_jacobian_hessian_and_vhp():
    a, b, v = _arr(4), _arr(4, seed=1), _arr(4, seed=2)
    _close_tree(tp.autograd.jacobian(_f_vec(tp), torch.tensor(a)),
                jp.autograd.jacobian(_f_vec(jp), jp.to_tensor(a)))
    _close_tree(tp.autograd.jacobian(_f2_vec(tp), [torch.tensor(a),
                                                   torch.tensor(b)]),
                jp.autograd.jacobian(_f2_vec(jp), [jp.to_tensor(a),
                                                   jp.to_tensor(b)]))
    _close_tree(tp.autograd.hessian(_f1(tp), torch.tensor(a)),
                jp.autograd.hessian(_f1(jp), jp.to_tensor(a)))
    th = tp.autograd.hessian(_f2(tp), [torch.tensor(a), torch.tensor(b)])
    assert len(th) == 2 and all(len(r) == 2 for r in th)
    _close_tree(th, jp.autograd.hessian(_f2(jp), [jp.to_tensor(a),
                                                  jp.to_tensor(b)]))
    _close_tree(tp.autograd.vhp(_f1(tp), torch.tensor(a), torch.tensor(v)),
                jp.autograd.vhp(_f1(jp), jp.to_tensor(a), jp.to_tensor(v)))
    _close_tree(tp.autograd.vhp(_f2(tp), [torch.tensor(a), torch.tensor(b)]),
                jp.autograd.vhp(_f2(jp), [jp.to_tensor(a), jp.to_tensor(b)]))


def test_jacobian_class_indexing():
    a, b = _arr(3), _arr(3, seed=1)
    jj = jp.autograd.Jacobian(_f_vec(jp), jp.to_tensor(a))
    tj = tp.autograd.Jacobian(_f_vec(tp), torch.tensor(a))
    assert tj.shape == jj.shape == [3, 3]
    _close(tj[1], jj[1])
    _close(tj[:, 2], jj[:, 2])
    np.testing.assert_allclose(tj.numpy(), jj.numpy(), rtol=TOL, atol=TOL)
    jj = jp.autograd.Jacobian(_f2_vec(jp), [jp.to_tensor(a),
                                            jp.to_tensor(b)])
    tj = tp.autograd.Jacobian(_f2_vec(tp), [torch.tensor(a),
                                            torch.tensor(b)])
    for i in range(2):
        _close(tj[i], jj[i])


# -- grad, the switches, backward, saved-tensor hooks -----------------------

def _graph(P, make):
    x, y, z = make(_arr(4)), make(_arr(4, seed=1)), make(_arr(4, seed=2))
    h = x * y
    return x, y, z, (h * h).sum(), (h + y).sum()


def test_grad_allow_unused_retain_graph_and_errors():
    jx, jy, jz, jo, jo2 = _graph(jp, _jt)
    tx, ty, tz, to, to2 = _graph(tp, _tt)
    jg = jp.grad(jo, [jx, jy], retain_graph=True)
    tg = tp.grad(to, [tx, ty], retain_graph=True)
    _close_tree(tg, jg)
    # retained: a second call on the same graph
    _close_tree(tp.grad(to, tx, retain_graph=True),
                jp.grad(jo, jx, retain_graph=True))
    assert tx.grad is None  # grad leaves .grad alone
    jg = jp.grad([jo2], [jx, jz], allow_unused=True)
    tg = tp.grad([to2], [tx, tz], allow_unused=True)
    assert tg[1] is None and jg[1] is None
    _close(tg[0], jg[0])
    # not retained: the shared part of the graph is gone in both
    with pytest.raises(RuntimeError, match="second time"):
        jp.grad(jo, jx)
    with pytest.raises(RuntimeError, match="second time"):
        tp.grad(to, tx)
    with pytest.raises(RuntimeError, match="allow_unused=True"):
        tp.grad((tx * 2).sum(), [tx, tz])
    with pytest.raises(NotImplementedError, match="create_graph"):
        tp.grad((tx * 2).sum(), tx, create_graph=True)
    # a cotangent for a non-scalar output
    v = _arr(4, seed=5)
    _close(tp.grad(tx * ty, tx, torch.tensor(v)),
           jp.grad(jx * jy, jx, jp.to_tensor(v)))


def test_no_grad_as_decorator_and_context_enable_grad_inside():
    for P, mk, needs in ((jp, _jt, lambda t: not t.stop_gradient),
                         (tp, _tt, lambda t: t.requires_grad)):
        x = mk(_arr(3))

        @P.no_grad()
        def double(t):
            return t * 2

        assert not needs(double(x))
        with P.no_grad():
            assert not needs(x * 2)
            assert not P.is_grad_enabled()
            with P.enable_grad():
                assert needs(x * 2)
        assert P.is_grad_enabled() and needs(x * 2)
        P.set_grad_enabled(False)
        try:
            assert not P.is_grad_enabled()
        finally:
            P.set_grad_enabled(True)
    with tp.set_grad_enabled_ctx(False):
        assert not tp.is_grad_enabled()
    assert tp.is_grad_enabled()


def test_backward_of_two_roots_sharing_intermediates():
    jx, jy, _, jo, jo2 = _graph(jp, _jt)
    tx, ty, _, to, to2 = _graph(tp, _tt)
    v = _arr(1, seed=7).reshape(())
    jp.autograd.backward([jo, jo2], [None, jp.to_tensor(v)])
    tp.autograd.backward([to, to2], [None, torch.tensor(v)])
    _close(tx.grad, jx.grad)
    _close(ty.grad, jy.grad)


def test_saved_tensors_hooks_see_every_saved_tensor():
    calls = {"j": [0, 0], "t": [0, 0]}
    grads = {}
    for key, P, mk in (("j", jp, _jt), ("t", tp, _tt)):
        def pack(t, c=calls[key]):
            c[0] += 1
            return t

        def unpack(t, c=calls[key]):
            c[1] += 1
            return t

        x = mk(_arr(4))
        with P.autograd.saved_tensors_hooks(pack, unpack):
            y = (P.exp(x) * x).sum()
        y.backward()
        grads[key] = x.grad
    _close(grads["t"], grads["j"])
    assert calls["t"][0] > 0 and calls["t"][1] > 0
    assert calls["j"][0] > 0 and calls["j"][1] > 0


def test_incubate_forward_grad_and_hessian():
    a, v = _arr(5), _arr(5, seed=3)
    # the reference computes J v from the function (its forward_grad
    # raises: its tape records reverse mode only); the port from the graph
    _, jv = jp.autograd.jvp(_f_vec(jp), jp.to_tensor(a), jp.to_tensor(v))
    tx = _tt(a)
    ty = _f_vec(tp)(tx)
    _close(tinc.forward_grad(ty, tx, torch.tensor(v)), jv)
    with pytest.raises(NotImplementedError):
        jinc.forward_grad(_f_vec(jp)(_jt(a)), _jt(a))
    jh = jinc.Hessian(_f1(jp), jp.to_tensor(a))
    th = tinc.Hessian(_f1(tp), torch.tensor(a))
    assert th.shape == list(jh.shape) == [5, 5]
    _close(th[2], jh[2])
    assert not tinc.prim_enabled()
    tinc.enable_prim()
    assert tinc.prim_enabled()
    tinc.disable_prim()
    assert not tinc.prim_enabled()
