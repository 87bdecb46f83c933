"""The port's recurrent layers held against the JAX package on the CPU.

- **Cells**: ``SimpleRNNCell`` (tanh and relu), ``LSTMCell`` and
  ``GRUCell`` with and without a given state: the step's outputs, states
  and every gradient within 1e-5 (fp32).
- **Layers**: ``SimpleRNN``, ``LSTM`` and ``GRU`` over layers,
  directions, ``time_major`` and initial states, and the ``RNN``/
  ``BiRNN`` wrappers of a cell: outputs, final states and every gradient
  within 1e-5; the weights are carried by name (``weight_ih_l0``,
  ``..._reverse``), with no mapping. Inter-layer dropout: eval equals the
  reference, training drops.
- **Beam search**: ``BeamSearchDecoder`` over a GRU cell with an
  embedding and an output layer, driven by ``dynamic_decode`` (with
  ``impute_finished`` and ``return_length``, batch- and time-major):
  tokens and lengths equal the reference's, scores within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as pnn
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.framework.device import using_device
from paddle_tpu_torch.nn.layer.layers import load_jax_weights

TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with using_device("cpu"):
        yield


def _carry(ref, port):
    load_jax_weights(port, {n: np.asarray(t.numpy())
                            for n, t in ref.state_dict().items()})
    return port


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _run_both(build, inputs, train=False):
    """Both packages' layer on ``inputs`` (numpy; every float input is
    differentiated): (outputs, gradients of inputs and parameters) of
    each, as numpy, for ``sum(out * cotangent)`` over the outputs."""
    ref, port = build(pnn), build(tnn)
    _carry(ref, port)
    ref.train() if train else ref.eval()
    port.train(train)
    rts = [None if a is None else pt.to_tensor(a, stop_gradient=False)
           for a in inputs]
    tts = [None if a is None else torch.tensor(a, requires_grad=True)
           for a in inputs]
    r_out = _leaves(ref(*rts))
    t_out = _leaves(port(*tts))
    rng = np.random.RandomState(5)
    cots = [rng.uniform(-1, 1, tuple(o.shape)).astype(np.float32)
            for o in r_out]
    loss = None
    for o, c in zip(r_out, cots):
        term = (o * pt.to_tensor(c)).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    tloss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(t_out, cots))
    tparams = dict(port.named_parameters())
    leaves = [t for t in tts if t is not None] + list(tparams.values())
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    rgrads = [t.grad for t in rts if t is not None] + [
        dict(ref.named_parameters())[n].grad for n in tparams]
    return ([np.asarray(o.numpy()) for o in r_out],
            [o.detach().numpy() for o in t_out],
            [None if g is None else np.asarray(g.numpy()) for g in rgrads],
            [None if g is None else g.numpy() for g in tgrads])


def _assert_match(build, inputs):
    r_out, t_out, r_g, t_g = _run_both(build, inputs)
    assert len(r_out) == len(t_out)
    for r, t in zip(r_out, t_out):
        np.testing.assert_allclose(t, r, rtol=0,
                                   atol=TOL * max(np.abs(r).max(), 1.0))
    for r, t in zip(r_g, t_g):
        r = np.zeros_like(t) if r is None else r
        t = np.zeros_like(r) if t is None else t
        np.testing.assert_allclose(t, r, rtol=0,
                                   atol=TOL * max(np.abs(r).max(), 1.0))


_R = np.random.RandomState(17)


def _f32(*shape):
    return _R.uniform(-1, 1, shape).astype(np.float32)


X4, H6, C6 = _f32(3, 4), _f32(3, 6), _f32(3, 6)

CELLS = [
    ("simple_tanh", lambda nn: nn.SimpleRNNCell(4, 6), (X4,)),
    ("simple_relu", lambda nn: nn.SimpleRNNCell(4, 6, "relu"), (X4, H6)),
    ("lstm", lambda nn: nn.LSTMCell(4, 6), (X4,)),
    ("lstm_state", lambda nn: _Pair(nn.LSTMCell(4, 6)), (X4, H6, C6)),
    ("gru", lambda nn: nn.GRUCell(4, 6), (X4, H6)),
]


class _Pair:
    """An LSTM cell called with ``(h, c)`` from two inputs."""

    def __new__(cls, cell):
        base = type(cell).__mro__[1]  # the package's Layer below the cell
        while base.__name__ != "Layer":
            base = base.__mro__[1]

        class Wrap(base):
            def __init__(self):
                super().__init__()
                self.cell = cell

            def forward(self, x, h, c):
                return self.cell(x, (h, c))

        return Wrap()


@pytest.mark.parametrize("build,inputs", [c[1:] for c in CELLS],
                         ids=[c[0] for c in CELLS])
def test_cells_match_the_reference(build, inputs):
    _assert_match(build, inputs)


SEQ = _f32(2, 5, 4)
SEQ_T = np.ascontiguousarray(SEQ.transpose(1, 0, 2))
H0_2x2 = _f32(4, 2, 6)
C0_2x2 = _f32(4, 2, 6)

LAYERS = [
    ("simple_rnn", lambda nn: nn.SimpleRNN(4, 6), (SEQ,)),
    ("simple_rnn_relu_2l_bi", lambda nn: nn.SimpleRNN(
        4, 6, 2, "bidirect", activation="relu"), (SEQ, H0_2x2)),
    ("gru", lambda nn: nn.GRU(4, 6), (SEQ,)),
    ("gru_2l_bi_time_major", lambda nn: nn.GRU(
        4, 6, 2, "bidirectional", time_major=True), (SEQ_T, H0_2x2)),
    ("lstm", lambda nn: nn.LSTM(4, 6), (SEQ,)),
    ("lstm_3l", lambda nn: nn.LSTM(4, 6, 3), (SEQ,)),
    ("lstm_2l_bi_states", lambda nn: _LSTMWith(nn.LSTM(
        4, 6, 2, "bidirect")), (SEQ, H0_2x2, C0_2x2)),
    ("lstm_time_major", lambda nn: nn.LSTM(4, 6, time_major=True),
     (SEQ_T,)),
    ("rnn_wrapper_gru", lambda nn: nn.RNN(nn.GRUCell(4, 6)), (SEQ,)),
    ("rnn_wrapper_reverse_time_major", lambda nn: nn.RNN(
        nn.SimpleRNNCell(4, 6), is_reverse=True, time_major=True),
     (SEQ_T,)),
    ("birnn_lstm", lambda nn: nn.BiRNN(nn.LSTMCell(4, 6),
                                       nn.LSTMCell(4, 6)), (SEQ,)),
]


def _LSTMWith(lstm):
    base = type(lstm).__mro__[1]
    while base.__name__ != "Layer":
        base = base.__mro__[1]

    class Wrap(base):
        def __init__(self):
            super().__init__()
            self.lstm = lstm

        def forward(self, x, h, c):
            return self.lstm(x, (h, c))

    return Wrap()


@pytest.mark.parametrize("build,inputs", [c[1:] for c in LAYERS],
                         ids=[c[0] for c in LAYERS])
def test_layers_match_the_reference(build, inputs):
    _assert_match(build, inputs)


def test_parameter_names_need_no_mapping():
    ref = pnn.LSTM(3, 4, num_layers=2, direction="bidirect")
    port = tnn.LSTM(3, 4, num_layers=2, direction="bidirect")
    names = [n for n, _ in port.named_parameters()]
    assert names == [n for n, _ in ref.named_parameters()]
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]
    assert "weight_ih_l1_reverse" in names
    assert port.weight_ih_l1.shape == (16, 8)


def test_inter_layer_dropout():
    """Eval mode is the reference's function; training drops between the
    layers (torch's draw), so two training calls differ and neither equals
    eval, while the last layer's output is never dropped to exact
    zeros."""
    ref = pnn.LSTM(4, 6, 3, dropout=0.5)
    port = _carry(ref, tnn.LSTM(4, 6, 3, dropout=0.5))
    ref.eval()
    port.eval()
    want = np.asarray(ref(pt.to_tensor(SEQ))[0].numpy())
    got = port(torch.from_numpy(SEQ))[0].detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    port.train()
    a = port(torch.from_numpy(SEQ))[0]
    b = port(torch.from_numpy(SEQ))[0]
    assert not torch.equal(a, b)
    assert not np.allclose(a.detach().numpy(), want, atol=1e-3)


VOCAB, HID = 12, 8


def _decoder(nn, beam):
    return nn.BeamSearchDecoder(
        nn.GRUCell(HID, HID), start_token=0, end_token=1, beam_size=beam,
        embedding_fn=nn.Embedding(VOCAB, HID),
        output_fn=nn.Linear(HID, VOCAB))


@pytest.mark.parametrize("beam,time_major,impute", [
    (3, False, False), (4, True, True), (1, False, True)])
def test_beam_search_tokens_equal_the_references(beam, time_major, impute):
    ref = _decoder(pnn, beam)
    port = _carry(ref, _decoder(tnn, beam))
    # the end token's logit raised, so that some beams end early
    with torch.no_grad():
        port.output_fn.bias[1] += 2.0
    _carry_back(port, ref)
    h0 = _f32(3, HID) * 2
    kw = dict(max_step_num=9, output_time_major=time_major,
              impute_finished=impute, return_length=True)
    r_ids, r_scores, r_len = pnn.dynamic_decode(ref, inits=pt.to_tensor(h0),
                                                **kw)
    with torch.no_grad():
        t_ids, t_scores, t_len = tnn.dynamic_decode(
            port, inits=torch.from_numpy(h0), **kw)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(r_ids.numpy()))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(r_len.numpy()))
    np.testing.assert_allclose(t_scores.numpy(),
                               np.asarray(r_scores.numpy()), atol=TOL,
                               rtol=TOL)
    assert (t_ids.numpy() == 1).any()  # some beam finished


def _carry_back(port, ref):
    """The port's weights into the reference layer, by name."""
    ref.set_state_dict({n: t.detach().numpy()
                        for n, t in port.state_dict().items()})
