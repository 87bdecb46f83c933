"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``): the
cells, ``SimpleRNN``/``LSTM``/``GRU`` over layers and directions, the
``RNN``/``BiRNN`` wrappers of a cell, and beam-search decoding.

The equations are the reference's (``rnn.py:41-137``), whose gate order
(LSTM ``i, f, g, o``; GRU ``r, z, n`` with the reset gate applied to
``h @ W_hh^T + b_hh``) and weight layout (``[gates * hidden, in]``) are
torch's. So the cells run torch's fused cell ops and the layers torch's
fused sequence ops (``torch.lstm``, ``torch.gru``, ``torch.rnn_tanh``,
``torch.rnn_relu``: cuDNN on the card). The reference computes them in
XLA (``lax.scan``), not in a Pallas kernel, so these library calls port
no kernel. The parameter names are the reference's: ``weight_ih_l0``,
``bias_hh_l1_reverse``, ... on the layers, ``weight_ih``, ... on a cell.
Inter-layer dropout is torch's draw (the reference's is ``jax.random``:
the same distribution, not the same bits). ``sequence_length`` is
accepted and ignored, as in the reference.
"""
from __future__ import annotations

import math

import torch

from .. import initializer as I
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
           "SimpleRNN", "LSTM", "GRU", "RNN", "BiRNN", "BeamSearchDecoder",
           "dynamic_decode"]


class RNNCellBase(Layer):
    """A cell's ``weight_ih`` ``[gates * hidden, input]``, ``weight_hh``
    ``[gates * hidden, hidden]``, ``bias_ih`` and ``bias_hh``, all drawn
    from ``U(+-1/sqrt(hidden))``."""

    def __init__(self, input_size, hidden_size, gates, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 *, device=None, generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=I.Uniform(-std, std), device=device,
                  generator=generator)
        n = gates * hidden_size
        self.weight_ih = self.create_parameter(
            [n, input_size], attr=weight_ih_attr, **kw)
        self.weight_hh = self.create_parameter(
            [n, hidden_size], attr=weight_hh_attr, **kw)
        self.bias_ih = self.create_parameter([n], attr=bias_ih_attr,
                                             is_bias=True, **kw)
        self.bias_hh = self.create_parameter([n], attr=bias_hh_attr,
                                             is_bias=True, **kw)

    def _zeros(self, inputs):
        return inputs.new_zeros((inputs.shape[0], self.hidden_size))

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, ``act`` tanh or
    relu; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 **kwargs):
        super().__init__(input_size, hidden_size, 1, **kwargs)
        self.activation = activation

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        cell = torch.rnn_relu_cell if self.activation == "relu" \
            else torch.rnn_tanh_cell
        h = cell(inputs, h, *self._weights())
        return h, h


class LSTMCell(RNNCellBase):
    """The LSTM step; ``states`` is ``(h, c)``; returns ``(h', (h',
    c'))``."""

    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__(input_size, hidden_size, 4, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            states = (self._zeros(inputs), self._zeros(inputs))
        h, c = torch.lstm_cell(inputs, tuple(states), *self._weights())
        return h, (h, c)


class GRUCell(RNNCellBase):
    """The GRU step; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__(input_size, hidden_size, 3, **kwargs)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        h = torch.gru_cell(inputs, h, *self._weights())
        return h, h


_SEQUENCE_OPS = {"lstm": torch.lstm, "gru": torch.gru}
_GATES = {"lstm": 4, "gru": 3, "rnn": 1}


class _RNNBase(Layer):
    """``num_layers`` layers of one or two directions (``direction`` in
    ``"forward"``, ``"bidirect"``, ``"bidirectional"``); inputs ``[b, t,
    in]`` (``[t, b, in]`` with ``time_major``); ``dropout`` between
    layers while training. Returns ``(outputs, final states)``, the
    states ``[num_layers * directions, b, hidden]`` (LSTM: ``(h,
    c)``)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirectional else 1
        n = _GATES[mode] * hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(default_initializer=I.Uniform(-std, std), device=device,
                  generator=generator)
        self._flat = []
        for layer in range(num_layers):
            in_size = input_size if layer == 0 \
                else hidden_size * self.num_directions
            for d in range(self.num_directions):
                suffix = f"l{layer}" + ("_reverse" if d else "")
                for name, shape, attr, is_bias in (
                        ("weight_ih", [n, in_size], weight_ih_attr, False),
                        ("weight_hh", [n, hidden_size], weight_hh_attr,
                         False),
                        ("bias_ih", [n], bias_ih_attr, True),
                        ("bias_hh", [n], bias_hh_attr, True)):
                    p = self.create_parameter(shape, attr=attr,
                                              is_bias=is_bias, **kw)
                    self.add_parameter(f"{name}_{suffix}", p)
                    self._flat.append(f"{name}_{suffix}")

    def forward(self, inputs, initial_states=None, sequence_length=None):
        nd, hs = self.num_directions, self.hidden_size
        b = inputs.shape[1] if self.time_major else inputs.shape[0]
        zeros = inputs.new_zeros((self.num_layers * nd, b, hs))
        weights = [getattr(self, name) for name in self._flat]
        args = (True, self.num_layers,
                float(self.dropout) if self.training else 0.0,
                self.training, self.bidirectional, not self.time_major)
        if self.mode == "lstm":
            h0, c0 = (zeros, zeros) if initial_states is None \
                else initial_states
            out, h, c = torch.lstm(inputs, (h0, c0), weights, *args)
            return out, (h, c)
        h0 = zeros if initial_states is None else initial_states
        op = _SEQUENCE_OPS.get(self.mode) or (
            torch.rnn_relu if self.activation == "relu" else torch.rnn_tanh)
        out, h = op(inputs, h0, weights, *args)
        return out, h


class SimpleRNN(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__("rnn", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, activation,
                         **kwargs)


class LSTM(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("lstm", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class GRU(_RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **kwargs):
        super().__init__("gru", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, **kwargs)


class RNN(Layer):
    """Runs ``cell`` over the time steps (last to first with
    ``is_reverse``); returns ``(outputs stacked over time, final
    states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        xs = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(xs.shape[0])
        states = initial_states
        outs = []
        for t in (reversed(steps) if self.is_reverse else steps):
            out, states = self.cell(xs[t], states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        stacked = torch.stack(outs, 0)
        return (stacked if self.time_major else stacked.transpose(0, 1)), \
            states


class BiRNN(Layer):
    """A forward and a backward :class:`RNN`, their outputs concatenated
    on the last dim; states ``(forward's, backward's)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw, bw = (None, None) if initial_states is None else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, fw)
        out_bw, st_bw = self.rnn_bw(inputs, bw)
        return torch.cat([out_fw, out_bw], -1), (st_fw, st_bw)


def _tree_map(fn, obj):
    if isinstance(obj, (tuple, list)):
        return tuple(_tree_map(fn, o) for o in obj)
    return fn(obj)


class BeamSearchDecoder(Layer):
    """Beam search over a cell (``rnn.py:333-460``), driven by
    :func:`dynamic_decode`: ``initialize(states)`` -> (ids, states,
    finished) and ``step(time, inputs, states, finished=)`` -> (tokens,
    states, next inputs, finished). Beams ride the batch dim (``[b * k,
    ...]``). Each step takes the ``beam_size`` best of ``k * vocab``
    continuations by summed log-probability (a finished beam continues
    only with ``end_token``, at no cost; ties go to the lower index, as
    ``lax.top_k`` breaks them), regathers the states and the token
    history by parent beam and appends the token."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def _gather_beam(self, t, parent):
        b = parent.shape[0]
        flat = (torch.arange(b, device=parent.device)[:, None]
                * self.beam_size + parent).reshape(-1)
        return t[flat]

    def initialize(self, initial_states, batch_size=None, dtype="float32"):
        states = _tree_map(
            lambda t: t.repeat_interleave(self.beam_size, 0), initial_states)
        flat = states
        while isinstance(flat, (tuple, list)):
            flat = flat[0]
        bk = flat.shape[0]
        b = bk // self.beam_size
        dev = flat.device
        ids = torch.full((bk,), self.start_token, dtype=torch.int64,
                         device=dev)
        # beam 0 live, the rest muted, so step 1 expands one start beam
        self._log_probs = torch.full((b, self.beam_size), -1e9,
                                     dtype=torch.float32, device=dev)
        self._log_probs[:, 0] = 0.0
        self._seqs = None
        finished = torch.zeros((b, self.beam_size), dtype=torch.bool,
                               device=dev)
        return ids, states, finished

    def step(self, time, inputs, states, **kwargs):
        emb = self.embedding_fn(inputs) if self.embedding_fn else inputs
        cell_out, next_states = self.cell(emb, states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        k, fin = self.beam_size, kwargs["finished"]
        bk, v = logits.shape
        b = bk // k
        logp = torch.log_softmax(logits.to(torch.float32), -1).reshape(
            b, k, v)
        end_only = torch.where(
            torch.arange(v, device=logp.device) == self.end_token, 0.0,
            -1e30)
        logp = torch.where(fin[:, :, None], end_only, logp)
        scores = (self._log_probs[:, :, None] + logp).reshape(b, k * v)
        top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top, idx = top[:, :k], idx[:, :k]
        parent = idx // v
        token = idx % v
        fin_next = torch.gather(fin, 1, parent) | (token == self.end_token)
        self._log_probs = top
        next_states = _tree_map(lambda s: self._gather_beam(s, parent),
                                next_states)
        prev = None if self._seqs is None else torch.gather(
            self._seqs, 1,
            parent[:, :, None].expand(-1, -1, self._seqs.shape[2]))
        self._seqs = token[:, :, None] if prev is None \
            else torch.cat([prev, token[:, :, None]], 2)
        return token, next_states, token.reshape(-1), fin_next

    def finalize(self):
        """(the ids ``[b, t, k]``, their scores ``[b, k]``)."""
        return self._seqs.transpose(1, 2), self._log_probs


def _tree_map2(fn, a, b):
    """``fn`` over the leaves of two state trees (tuples, lists,
    namedtuples, dicts, tensors); where their structures differ, the new
    value ``b``."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        if type(b) is not type(a):
            return b
        return type(a)(*(_tree_map2(fn, x, y) for x, y in zip(a, b)))
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return b
        return type(a)(_tree_map2(fn, x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return b
        return {k: _tree_map2(fn, a[k], b[k]) for k in a}
    if a is None or b is None:
        return b
    return fn(a, b)


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, impute_finished=False,
                   is_test=False, return_length=False, **kwargs):
    """Step ``decoder`` until every beam has finished or ``max_step_num``
    steps (default 100), a loop on the host (``rnn.py:476-529``). With
    ``impute_finished`` the states of beams finished before a step keep
    their values through it. Returns (ids, scores) and, with
    ``return_length``, each beam's count of tokens other than
    ``end_token``."""
    max_steps = int(max_step_num or 100)
    inputs, states, finished = decoder.initialize(inits)
    for t in range(max_steps):
        prev_states, prev_finished = states, finished
        _, states, inputs, finished = decoder.step(t, inputs, states,
                                                   finished=finished)
        if impute_finished:
            m = prev_finished.reshape(-1)

            def freeze(old, new):
                if new.dim() == 0 or old.shape != new.shape \
                        or m.shape[0] != new.shape[0]:
                    return new
                return torch.where(
                    m.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

            states = _tree_map2(freeze, prev_states, states)
        if bool(finished.all()):
            break
    ids, scores = decoder.finalize()
    if output_time_major:
        ids = ids.transpose(0, 1)
    if not return_length:
        return ids, scores
    lengths = (ids != decoder.end_token).to(torch.int32).sum(
        0 if output_time_major else 1, dtype=torch.int32)
    return ids, scores, lengths
