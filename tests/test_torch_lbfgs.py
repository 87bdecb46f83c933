"""The port's ``optimizer.LBFGS`` held against the JAX package's on the
CPU: both line searches (``None``: Armijo backtracking, and
``"strong_wolfe"``), driven by a closure.

- a convex quadratic ``0.5 w'Aw - b'w`` over one ``[5, 1]`` weight:
  3 steps of up to 5 iterations, the loss after each and the final
  weight within 1e-6 of the reference's (float64 host arithmetic on both
  sides; the closures' fp32 products differ only in summation order),
  and the minimum ``A^-1 b`` reached (1e-4);
- a tiny fp32 regression network (two ``Linear`` layers and a tanh) on
  seeded data: 4 steps of up to 3 iterations, losses within 1e-5 and
  every parameter within 1e-5 of the reference's (more iterations let
  the line searches turn fp32 summation-order noise into different
  trial points);
- a missing closure and an unknown line search raise, as there.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import nn as jnn
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import LBFGS

SEARCHES = [None, "strong_wolfe"]


def _copy(jl, tl):
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.array(jl.weight.numpy())))
        if tl.bias is not None:
            tl.bias.copy_(torch.from_numpy(np.array(jl.bias.numpy())))


def _quadratic():
    rng = np.random.RandomState(0)
    m = rng.randn(5, 5).astype(np.float32)
    a = (m @ m.T + 5 * np.eye(5)).astype(np.float32)
    b = rng.randn(5, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("search", SEARCHES)
def test_quadratic_matches_reference(search):
    a, b = _quadratic()
    pt.seed(0)
    jl = jnn.Linear(5, 1, bias_attr=False)
    tl = Linear(5, 1, bias_attr=False, device="cpu")
    _copy(jl, tl)
    ja, jb = pt.to_tensor(a), pt.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jopt = pt.optimizer.LBFGS(learning_rate=1.0, max_iter=5,
                              line_search_fn=search,
                              parameters=jl.parameters())
    topt = LBFGS(learning_rate=1.0, max_iter=5, line_search_fn=search,
                 parameters=tl.parameters())

    def jclosure():
        w = jl.weight
        loss = 0.5 * (w * pt.matmul(ja, w)).sum() - (jb * w).sum()
        loss.backward()
        return loss

    def tclosure():
        w = tl.weight
        loss = 0.5 * (w * (ta @ w)).sum() - (tb * w).sum()
        loss.backward()
        return loss

    for _ in range(3):
        jv = float(jopt.step(jclosure).numpy())
        tv = float(topt.step(tclosure))
        assert abs(jv - tv) < 1e-6, (jv, tv)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               jl.weight.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.linalg.solve(a, b), atol=1e-4)


@pytest.mark.parametrize("search", SEARCHES)
def test_tiny_model_matches_reference(search):
    rng = np.random.RandomState(1)
    x = rng.randn(16, 4).astype(np.float32)
    y = np.sin(x.sum(1, keepdims=True)).astype(np.float32)
    pt.seed(0)
    jl1, jl2 = jnn.Linear(4, 8), jnn.Linear(8, 1)
    tl1, tl2 = Linear(4, 8, device="cpu"), Linear(8, 1, device="cpu")
    _copy(jl1, tl1)
    _copy(jl2, tl2)
    jparams = jl1.parameters() + jl2.parameters()
    tparams = list(tl1.parameters()) + list(tl2.parameters())
    jopt = pt.optimizer.LBFGS(learning_rate=0.5, max_iter=3,
                              line_search_fn=search, parameters=jparams)
    topt = LBFGS(learning_rate=0.5, max_iter=3, line_search_fn=search,
                 parameters=tparams)
    jx, jy = pt.to_tensor(x), pt.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def jclosure():
        loss = ((jl2(pt.tanh(jl1(jx))) - jy) ** 2).mean()
        loss.backward()
        return loss

    def tclosure():
        loss = ((tl2(torch.tanh(tl1(tx))) - ty) ** 2).mean()
        loss.backward()
        return loss

    losses = ([], [])
    for _ in range(4):
        losses[0].append(float(jopt.step(jclosure).numpy()))
        losses[1].append(float(topt.step(tclosure)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=1e-5)
    assert losses[1][-1] < losses[1][0]
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), rtol=0,
                                   atol=1e-5)


def test_lbfgs_errors():
    tl = Linear(2, 1, device="cpu")
    with pytest.raises(ValueError, match="line_search_fn"):
        LBFGS(line_search_fn="hager_zhang", parameters=tl.parameters())
    with pytest.raises(ValueError, match="closure"):
        LBFGS(parameters=tl.parameters()).step()
