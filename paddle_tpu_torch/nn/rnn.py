"""Recurrent layers (port of ``paddle_tpu/nn/rnn.py``).

Weights in Paddle's layout (``weight_ih: [gates * hidden, input]``), gates
ordered i, f, c, o for the LSTM and r, z, c for the GRU, with ``c = tanh(ic
+ r * (W_hc h + b_hc))`` and ``h' = (1 - z) c + z h``: torch's own cells'
layout and formulas.  So the multi-layer nets (:class:`SimpleRNN`,
:class:`LSTM`, :class:`GRU`), whose parameters are named
``weight_ih_l{k}[_reverse]`` etc. as in the JAX package, run torch's
recurrent kernel (cuDNN on a card) over their own parameters, where the
JAX package runs ``lax.scan``.  As there, they start from zero states
(``initial_states`` and ``sequence_length`` are not ported) and apply no
dropout between layers.  The cells and :class:`RNN` are plain torch ops.
"""

from __future__ import annotations

import math

import torch

from .initializer import Uniform
from .layers import Layer

__all__ = ["SimpleRNN", "LSTM", "GRU", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN"]


class _RNNCellBase(Layer):
    def __init__(self, input_size, hidden_size, gates, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self.input_size, self.hidden_size = input_size, hidden_size
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        g = gates * hidden_size
        self.weight_ih = self.create_parameter([g, input_size], attr=weight_ih_attr,
                                               default_initializer=init)
        self.weight_hh = self.create_parameter([g, hidden_size], attr=weight_hh_attr,
                                               default_initializer=init)
        self.bias_ih = (None if bias_ih_attr is False else self.create_parameter(
            [g], attr=bias_ih_attr, is_bias=True, default_initializer=init))
        self.bias_hh = (None if bias_hh_attr is False else self.create_parameter(
            [g], attr=bias_hh_attr, is_bias=True, default_initializer=init))

    def _zeros(self, x):
        return x.new_zeros(x.shape[0], self.hidden_size)

    def _gates(self, x, h):
        gi, gh = x @ self.weight_ih.T, h @ self.weight_hh.T
        if self.bias_ih is not None:
            gi = gi + self.bias_ih
        if self.bias_hh is not None:
            gh = gh + self.bias_hh
        return gi, gh


class SimpleRNNCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh", **kw):
        super().__init__(input_size, hidden_size, 1, **kw)
        self.activation = activation

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        gi, gh = self._gates(inputs, h)
        h = torch.tanh(gi + gh) if self.activation == "tanh" else torch.relu(gi + gh)
        return h, h


class LSTMCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size, 4, **kw)

    def forward(self, inputs, states=None):
        h, c = (self._zeros(inputs), self._zeros(inputs)) if states is None else states
        gi, gh = self._gates(inputs, h)
        i, f, g, o = (gi + gh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)


class GRUCell(_RNNCellBase):
    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(input_size, hidden_size, 3, **kw)

    def forward(self, inputs, states=None):
        h = self._zeros(inputs) if states is None else states
        gi, gh = self._gates(inputs, h)
        ir, iz, ic = gi.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
        h = (1 - z) * torch.tanh(ic + r * hc) + z * h
        return h, h


class RNN(Layer):
    """A cell run over the time axis (axis 1, or 0 with ``time_major``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell, self.is_reverse, self.time_major = cell, is_reverse, time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        t_axis = 0 if self.time_major else 1
        steps = range(inputs.shape[t_axis])
        outputs, states = [], initial_states
        for t in (reversed(steps) if self.is_reverse else steps):
            out, states = self.cell(inputs.select(t_axis, t), states)
            outputs.append(out)
        if self.is_reverse:
            outputs = outputs[::-1]
        return torch.stack(outputs, dim=t_axis), states


class _RNNBase(Layer):
    """Multi-layer, optionally bidirectional net over torch's recurrent kernel."""

    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self.input_size, self.hidden_size, self.num_layers = input_size, hidden_size, num_layers
        self.time_major, self.dropout, self.activation = time_major, dropout, activation
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        std = 1.0 / math.sqrt(hidden_size)
        init = Uniform(-std, std)
        g = self.GATES * hidden_size
        self._weight_names = []
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_sz = input_size if layer == 0 else hidden_size * self.num_directions
                sfx = f"_l{layer}{'_reverse' if d else ''}"
                for name, shape, is_bias in ((f"weight_ih{sfx}", [g, in_sz], False),
                                             (f"weight_hh{sfx}", [g, hidden_size], False),
                                             (f"bias_ih{sfx}", [g], True),
                                             (f"bias_hh{sfx}", [g], True)):
                    self.register_parameter(name, self.create_parameter(
                        shape, is_bias=is_bias, default_initializer=init))
                    self._weight_names.append(name)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is not None or sequence_length is not None:
            raise NotImplementedError("paddle_tpu_torch: the multi-layer nets start from zero "
                                      "states over whole sequences, as the JAX package's")
        x = inputs if self.time_major else inputs.transpose(0, 1)      # [T, B, F]
        h0 = x.new_zeros(self.num_layers * self.num_directions, x.shape[1], self.hidden_size)
        weights = [getattr(self, n) for n in self._weight_names]
        args = (weights, True, self.num_layers, 0.0, self.training, self.bidirect, False)
        if self.MODE == "LSTM":
            out, h, c = torch._VF.lstm(x, (h0, torch.zeros_like(h0)), *args)
            states = (h, c)
        else:
            fn = {"GRU": torch._VF.gru, "RNN_TANH": torch._VF.rnn_tanh,
                  "RNN_RELU": torch._VF.rnn_relu}[self.MODE]
            out, states = fn(x, h0, *args)
        return (out if self.time_major else out.transpose(0, 1)), states


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.activation != "tanh":
            self.MODE = "RNN_RELU"


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3
