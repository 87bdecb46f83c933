"""The port's ``Layer`` API, ``ParamAttr`` and layer placement held
against the JAX package on the CPU.

- **ParamAttr and Linear** (``ParamAttr``'s six parameters in the
  reference's order; ``create_parameter``'s ``optimize_attr``,
  ``regularizer``, ``need_clip`` and global initializer; ``Linear`` as a
  ``Layer`` taking ``(in, out, weight_attr, bias_attr, name)``): a
  ``learning_rate=0.5`` weight moves under SGD as the reference's does,
  half as far as one at the default rate, and a ``need_clip=False``
  parameter escapes ``ClipGradByGlobalNorm`` as in the reference.
- **The Layer API** (``layers.py:64-350``): list-valued ``parameters()``
  with ``include_sublayers``, sublayers, ``add_sublayer``/
  ``add_parameter``, Paddle's hooks, ``to``/``astype``, ``full_name``,
  ``ParameterList``, ``LayerDict``, and ``state_dict`` names equal to
  the reference's for every layer family.
- **Placement**: a layer is built on ``framework.device.current_device()``
  (``set_device("cpu")`` puts it on the CPU; with nothing asked it is the
  card, and a host without one raises).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as pnn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.device import get_device, using_device


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _weights(layer):
    return {n: np.asarray(t.numpy()) for n, t in layer.state_dict().items()}


def _port_of(ref_layer, port_layer):
    tnn.layer.layers.load_jax_weights(port_layer, _weights(ref_layer))
    return port_layer


def test_param_attr_takes_the_reference_parameters_in_order():
    init = pnn.initializer.Constant(2.0)
    a = tnn.ParamAttr("w", tnn.initializer.Constant(2.0), 0.5, None, False,
                      False)
    r = pnn.ParamAttr("w", init, 0.5, None, False, False)
    for k in ("name", "learning_rate", "regularizer", "trainable",
              "need_clip"):
        assert getattr(a, k) == getattr(r, k), k
    p = tnn.Layer().create_parameter([3], attr=a)
    assert p.optimize_attr == {"learning_rate": 0.5}
    assert p.need_clip is False and p.regularizer is None
    assert not p.requires_grad and torch.equal(p, torch.full((3,), 2.0))


def test_learning_rate_attr_moves_the_weight_as_the_reference():
    """SGD at lr 0.1 over one step: the ``learning_rate=0.5`` weight moves
    half as far as the bias at the default rate, in both packages."""
    rl = pnn.Linear(4, 3, pnn.ParamAttr(learning_rate=0.5), None)
    tl = _port_of(rl, tnn.Linear(4, 3, tnn.ParamAttr(learning_rate=0.5),
                                 None))
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    before = _weights(rl)
    rop = pt.optimizer.SGD(0.1, parameters=rl.parameters())
    rl(pt.to_tensor(x)).sum().backward()
    rop.step()
    top = topt.SGD(0.1, parameters=tl.parameters())
    tl(torch.from_numpy(x)).sum().backward()
    top.step()
    for n, after in _weights(rl).items():
        got = tl.state_dict()[n].detach().numpy()
        np.testing.assert_allclose(got, after, rtol=0, atol=1e-6)
    gw = (before["weight"] - _weights(rl)["weight"]) / 0.1
    # dW = sum_rows(x) per column; its step is half of lr * dW
    np.testing.assert_allclose(gw, 0.5 * np.tile(x.sum(0)[:, None], 3),
                               rtol=1e-5)


def test_need_clip_false_escapes_the_global_norm_clip():
    rl = pnn.Linear(4, 3, bias_attr=pnn.ParamAttr(need_clip=False))
    tl = _port_of(rl, tnn.Linear(4, 3,
                                 bias_attr=tnn.ParamAttr(need_clip=False)))
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32) * 10
    rop = pt.optimizer.SGD(1.0, parameters=rl.parameters(),
                           grad_clip=pnn.ClipGradByGlobalNorm(0.01))
    rl(pt.to_tensor(x)).sum().backward()
    rop.step()
    top = topt.SGD(1.0, parameters=tl.parameters(),
                   grad_clip=tnn.ClipGradByGlobalNorm(0.01))
    tl(torch.from_numpy(x)).sum().backward()
    top.step()
    for n, want in _weights(rl).items():
        np.testing.assert_allclose(tl.state_dict()[n].detach().numpy(),
                                   want, rtol=0, atol=1e-6)
    # the bias took its whole gradient (5 per element): it escaped
    np.testing.assert_allclose(tl.bias.detach().numpy(), -5.0, atol=1e-6)


def test_linear_takes_the_reference_signature():
    lin = tnn.Linear(4, 3, None, False, device="cpu")
    assert isinstance(lin, tnn.Layer) and lin.bias is None
    assert list(lin.state_dict()) == ["weight"]
    w = tnn.ParamAttr(initializer=tnn.initializer.Constant(0.5))
    lin = tnn.Linear(4, 3, w)  # the third argument is weight_attr
    assert torch.equal(lin.weight, torch.full((4, 3), 0.5))
    assert torch.equal(lin.bias, torch.zeros(3))
    lin = tnn.Linear(4, 3, weight_attr=w, bias_attr=tnn.ParamAttr(
        initializer=tnn.initializer.Constant(1.0)), name="fc")
    assert torch.equal(lin.bias, torch.ones(3))


def test_global_initializer_applies_as_the_reference():
    tnn.initializer.set_global_initializer(
        tnn.initializer.Constant(0.25), tnn.initializer.Constant(0.75))
    try:
        lin = tnn.Linear(2, 2)
        emb_w = tnn.Layer().create_parameter([2, 2])
    finally:
        tnn.initializer.set_global_initializer(None)
    # Linear names its weight's default initializer: only the bias takes
    # the global one (layers.py:93-94)
    assert not torch.equal(lin.weight, torch.full((2, 2), 0.25))
    assert torch.equal(lin.bias, torch.full((2,), 0.75))
    assert torch.equal(emb_w, torch.full((2, 2), 0.25))


def test_parameters_are_lists_with_include_sublayers():
    r = pnn.Sequential(pnn.Linear(4, 8), pnn.Linear(8, 2))
    t = tnn.Sequential(tnn.Linear(4, 8), tnn.Linear(8, 2))
    assert len(t.parameters()) == len(r.parameters()) == 4
    assert t.parameters(include_sublayers=False) == []
    assert len(t[0].parameters(include_sublayers=False)) == 2
    assert [n for n, _ in t.named_parameters()] == \
        [n for n, _ in r.named_parameters()]
    assert next(iter(t.parameters())) is t[0].weight
    # torch's internals still reach every parameter
    t(torch.ones(1, 4)).sum().backward()
    t.zero_grad()
    assert all(p.grad is None for p in t.parameters())
    t.requires_grad_(False)
    assert not any(p.requires_grad for p in t.parameters())
    assert len(list(t.parameters(recurse=False))) == 0


def test_sublayers_and_registration():
    t = tnn.Sequential(tnn.Linear(2, 2), tnn.Sequential(tnn.ReLU()))
    r = pnn.Sequential(pnn.Linear(2, 2), pnn.Sequential(pnn.ReLU()))
    assert [n for n, _ in t.named_sublayers()] == \
        [n for n, _ in r.named_sublayers()]
    assert len(t.sublayers()) == len(r.sublayers()) == 3
    assert t.sublayers(include_self=True)[0] is t
    m = tnn.Layer()
    lin = m.add_sublayer("fc", tnn.Linear(2, 3))
    assert lin is m.fc and m.sublayers() == [lin]
    p = m.add_parameter("scale", torch.nn.Parameter(torch.ones(3)))
    assert m.scale is p and "scale" in m.state_dict()
    m.add_parameter("raw", torch.zeros(2))  # a tensor becomes a parameter
    assert isinstance(m.raw, torch.nn.Parameter)
    with pytest.raises(TypeError):
        m.add_parameter("bad", np.zeros(2))
    assert m.full_name() == "layer"
    assert tnn.Linear(2, 2).full_name() == pnn.Linear(2, 2).full_name()


def test_hooks_replace_inputs_and_outputs():
    lin = tnn.Linear(2, 2, bias_attr=False)
    with torch.no_grad():
        lin.weight.copy_(torch.eye(2))
    x = torch.tensor([[1.0, 2.0]])
    pre = lin.register_forward_pre_hook(lambda layer, inputs: inputs[0] * 3)
    post = lin.register_forward_post_hook(
        lambda layer, inputs, out: out + 1)
    torch.testing.assert_close(lin(x), x * 3 + 1)
    seen = []
    keep = lin.register_forward_post_hook(
        lambda layer, inputs, out: seen.append(out.clone()))
    lin(x)
    torch.testing.assert_close(seen[0], x * 3 + 1)  # None keeps the output
    assert isinstance(pre, tnn.layer.layers.HookRemoveHelper)
    pre.remove()
    post.remove()
    keep.remove()
    torch.testing.assert_close(lin(x), x)


def test_to_and_astype_take_paddle_arguments():
    t = tnn.Sequential(tnn.Linear(2, 3), tnn.BatchNorm1D(3))
    t.to(device="cpu", dtype="float16", blocking=True)
    assert t[0].weight.dtype == torch.float16
    assert t[1]._mean.dtype == torch.float16
    t.astype("float32")
    assert t[0].weight.dtype == torch.float32
    t.to("cpu")
    t.to(None, "bfloat16")
    assert t[0].weight.dtype == torch.bfloat16
    t.to(torch.float32)  # torch's form
    assert t[0].weight.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.to(device="gpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t.to("gpu:0")


def test_parameter_list_and_layer_dict():
    ps = [torch.nn.Parameter(torch.full((2,), float(i))) for i in range(3)]
    plist = tnn.ParameterList(ps[:2])
    plist.append(ps[2])
    assert len(plist) == 3 and plist[2] is ps[2]
    assert list(plist) == ps
    assert list(plist.state_dict()) == ["0", "1", "2"]
    assert list(plist.state_dict()) == list(pnn.ParameterList(
        [pnn.Linear(1, 1).weight for _ in range(3)]).state_dict())
    d = tnn.LayerDict({"a": tnn.Linear(2, 2), "b": tnn.ReLU()})
    d["c"] = tnn.Tanh()
    assert list(d.keys()) == ["a", "b", "c"] and "b" in d and len(d) == 3
    assert isinstance(d.pop("b"), tnn.ReLU) and list(d) == ["a", "c"]
    assert list(d.state_dict()) == list(pnn.LayerDict(
        {"a": pnn.Linear(2, 2), "c": pnn.Tanh()}).state_dict())
    d.update([("e", tnn.Linear(2, 1))])
    assert [k for k, _ in d.items()] == ["a", "c", "e"]
    d.clear()
    assert len(d) == 0


STATE_DICT_CASES = {
    "linear": lambda nn: nn.Linear(3, 4),
    "embedding": lambda nn: nn.Embedding(6, 4, padding_idx=0),
    "conv_transpose": lambda nn: nn.Conv2DTranspose(3, 4, 2),
    "batch_norm": lambda nn: nn.BatchNorm2D(3),
    "sync_batch_norm": lambda nn: nn.SyncBatchNorm(3),
    "layer_norm": lambda nn: nn.LayerNorm(4),
    "group_norm": lambda nn: nn.GroupNorm(2, 4),
    "instance_norm": lambda nn: nn.InstanceNorm2D(3),
    "spectral_norm": lambda nn: nn.SpectralNorm([4, 3]),
    "prelu": lambda nn: nn.PReLU(3),
    "bilinear": lambda nn: nn.Bilinear(2, 3, 4),
    "hsigmoid": lambda nn: nn.HSigmoidLoss(3, 5),
    "mha": lambda nn: nn.MultiHeadAttention(8, 2, kdim=6, vdim=4),
    "transformer": lambda nn: nn.Transformer(8, 2, 2, 1, 16),
    "transformer_pre": lambda nn: nn.Transformer(
        8, 2, 1, 1, 16, normalize_before=True),
    "lstm": lambda nn: nn.LSTM(3, 4, num_layers=2, direction="bidirect"),
    "gru": lambda nn: nn.GRU(3, 4),
    "simple_rnn": lambda nn: nn.SimpleRNN(3, 4, 2),
    "rnn_cell": lambda nn: nn.RNN(nn.LSTMCell(3, 4)),
    "birnn": lambda nn: nn.BiRNN(nn.GRUCell(3, 4), nn.GRUCell(3, 4)),
    "containers": lambda nn: nn.Sequential(
        nn.LayerList([nn.Linear(2, 2), nn.BatchNorm1D(2)]),
        nn.LayerDict({"a": nn.Conv1D(2, 2, 1)})),
}


@pytest.mark.parametrize("case", list(STATE_DICT_CASES))
def test_state_dict_names_are_the_references(case):
    """Names and shapes of ``state_dict()`` (parameters and persistable
    buffers) equal the reference's, so ``load_jax_weights`` carries a
    reference layer's state across by name; the parameters come in the
    reference's order (torch lists a layer's buffers beside its
    parameters, the reference after all of them)."""
    ref = STATE_DICT_CASES[case](pnn)
    port = STATE_DICT_CASES[case](tnn)
    rs, ts = ref.state_dict(), port.state_dict()
    assert sorted(ts) == sorted(rs)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    for n in rs:
        assert tuple(ts[n].shape) == tuple(rs[n].shape), n
    _port_of(ref, port)


def test_layers_are_built_on_the_current_device(monkeypatch):
    """``set_device("cpu")`` puts a layer built with no ``device`` on the
    CPU; asking for nothing gives the card (``"gpu:0"``), which raises on
    a host without one; ``device=`` overrides."""
    assert get_device() == "cpu"
    assert tnn.Linear(4, 3).weight.device.type == "cpu"
    assert tnn.LSTM(2, 3).weight_ih_l0.device.type == "cpu"
    assert tnn.Transformer(8, 2, 1, 1, 8).generate_square_subsequent_mask(
        3).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with using_device("gpu"):
        for build in (lambda: tnn.Linear(4, 3),
                      lambda: tnn.BatchNorm2D(3),
                      lambda: tnn.Conv2D(2, 2, 1),
                      lambda: tnn.Layer().create_parameter([2])):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        assert tnn.Linear(4, 3, device="cpu").weight.device.type == "cpu"
    ptt.set_device("cpu")
    assert tnn.Embedding(4, 2).weight.device.type == "cpu"


def test_paddle_attributes_survive_deepcopy():
    """``TransformerEncoder`` deep-copies its layer: each copy's
    parameters keep their ``optimize_attr`` and ``need_clip``."""
    attr = tnn.ParamAttr(learning_rate=0.25, need_clip=False)
    enc = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(
        8, 2, 16, weight_attr=attr), 3)
    ws = [layer.linear1.weight for layer in enc.layers]
    assert len({id(w) for w in ws}) == 3
    for w in ws:
        assert w.optimize_attr == {"learning_rate": 0.25}
        assert w.need_clip is False
