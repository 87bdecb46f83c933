"""The port's chunked softmax cross-entropy held against the JAX package
on the CPU (fp32; the same inputs from numpy seeds on both sides):

- the per-token loss, ``dh`` and ``dW`` of
  ``F.chunked_softmax_cross_entropy`` against the reference's, with a
  vocab the chunk divides and a ragged one, and labels outside ``[0,
  V)`` (which give 0 and no gradient): 1e-5, the two frameworks summing
  in different orders;
- a tiny Llama with ``ce_chunk_size`` (ragged: 128 = 3 x 48 - 16) against
  the JAX Llama with the same setting, and against its own plain CE:
  1e-5 on the loss, every gradient to 1e-5 of its largest value;
- ``chunk_size <= 0`` raises, as in the reference.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.models import (
    LlamaConfig, LlamaForCausalLM, load_jax_weights,
)
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-5


def _inputs(seed, n_rows, h, v):
    rng = np.random.RandomState(seed)
    hid = rng.randn(n_rows // 4, 4, h).astype(np.float32)
    w = (rng.randn(h, v) * 0.3).astype(np.float32)
    lab = rng.randint(0, v, (n_rows // 4, 4)).astype(np.int64)
    lab[0, 0] = -100  # ignored
    lab[1, 2] = v     # past the vocab
    g = rng.rand(n_rows // 4, 4).astype(np.float32)  # upstream gradient
    return hid, w, lab, g


def _jax(hid, w, lab, g, chunk):
    ht = pt.to_tensor(hid, stop_gradient=False)
    wt = pt.to_tensor(w, stop_gradient=False)
    out = JF.chunked_softmax_cross_entropy(ht, wt, pt.to_tensor(lab), chunk)
    (out * pt.to_tensor(g)).sum().backward()
    return out.numpy(), ht.grad.numpy(), wt.grad.numpy()


def _port(hid, w, lab, g, chunk):
    ht = torch.tensor(hid, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = TF.chunked_softmax_cross_entropy(ht, wt, torch.from_numpy(lab),
                                           chunk)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), ht.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("v, chunk", [(48, 16), (37, 16), (37, 64),
                                      (100, 32)])
def test_loss_and_grads_match_reference(v, chunk):
    hid, w, lab, g = _inputs(v, 24, 16, v)
    want = _jax(hid, w, lab, g, chunk)
    got = _port(hid, w, lab, g, chunk)
    for name, a, b in zip(("loss", "dh", "dW"), got, want):
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=TOL,
                                   err_msg=name)
    assert got[0][0, 0] == 0.0 and got[0][1, 2] == 0.0
    assert not got[1][0, 0].any() and not got[1][1, 2].any()


def test_chunked_matches_dense_port_loss():
    hid, w, lab, g = _inputs(1, 16, 8, 21)
    loss, dh, dw = _port(hid, w, lab, g, 8)
    ht = torch.tensor(hid, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    dense = TF.cross_entropy(ht @ wt, torch.from_numpy(lab)[..., None]
                             .clamp(max=20).masked_fill(
                                 torch.from_numpy(lab)[..., None] >= 21,
                                 -100), reduction="none")
    (dense * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(loss, dense.detach().numpy(), atol=TOL)
    np.testing.assert_allclose(dh, ht.grad.numpy(), atol=TOL)
    np.testing.assert_allclose(dw, wt.grad.numpy(), atol=TOL)


def test_bad_chunk_raises():
    with pytest.raises(ValueError, match="chunk_size"):
        TF.chunked_softmax_cross_entropy(torch.zeros(2, 4), torch.zeros(4, 8),
                                         torch.zeros(2, dtype=torch.long), 0)


def _llama_pair(chunk):
    cfg = dict(num_hidden_layers=2, use_parallel_cross_entropy=False,
               ce_chunk_size=chunk)
    pt.seed(3)
    jm = JaxLlama(JaxLlamaConfig.tiny(**cfg))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**cfg), device="cpu")
    load_jax_weights(tm, {n: np.asarray(p._data)
                          for n, p in jm.named_parameters()})
    return jm, tm


def test_llama_ce_chunk_size_matches_reference():
    jm, tm = _llama_pair(48)
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels = rng.randint(0, 128, (2, 16)).astype(np.int32)
    labels[0, :3] = -100
    jl = jm(pt.to_tensor(ids), pt.to_tensor(labels))
    jl.backward()
    tl = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=0,
                               atol=TOL)
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        scale = np.abs(jg[n]).max() + 1e-9
        np.testing.assert_allclose(p.grad.numpy() / scale, jg[n] / scale,
                                   rtol=0, atol=TOL, err_msg=n)
    # the same model without chunking gives the same loss
    tm.config.ce_chunk_size = 0
    plain = tm(torch.from_numpy(ids), torch.from_numpy(labels))
    np.testing.assert_allclose(float(plain), float(tl), rtol=0, atol=TOL)
