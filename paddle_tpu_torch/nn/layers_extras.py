"""The long tail of ``nn`` layers (port of ``paddle_tpu/nn/layers_extras.py``):
layers over :mod:`._functional_extras` (zero padding, ``Maxout``,
``Softmax2D``, unpooling, LP / fractional / adaptive-max pooling, feature
alpha dropout, the extra losses), the ``LayerDict`` / ``ParameterDict``
containers (torch's ``ModuleDict`` / ``ParameterDict``: a key is its
entry's ``state_dict`` name, as in the JAX package), ``BiRNN`` (``rnn_fw`` /
``rnn_bw``) and beam search (:class:`BeamSearchDecoder` with
:func:`dynamic_decode`, a host loop as the JAX one).

``HSigmoidLoss`` holds ``weight`` ``[num_classes - 1, feature_size]`` and
``bias``; ``AdaptiveLogSoftmaxWithLoss`` ``head_weight`` (``head_bias``)
and ``tail_{i}_proj`` / ``tail_{i}_out``: the JAX names, so
``models.convert`` carries them.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch import nn

from ..framework.tensor import unwrap, wrap
from . import functional as F
from .common_layers import _PadND
from .layers import Layer
from .rnn import RNN, _RNNCellBase

__all__ = [
    "ZeroPad1D", "ZeroPad3D", "Maxout", "Softmax2D",
    "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D",
    "LPPool1D", "LPPool2D", "FractionalMaxPool2D", "FractionalMaxPool3D",
    "AdaptiveMaxPool3D", "FeatureAlphaDropout",
    "MultiMarginLoss", "TripletMarginWithDistanceLoss", "HSigmoidLoss",
    "RNNTLoss", "AdaptiveLogSoftmaxWithLoss",
    "LayerDict", "ParameterDict", "RNNCellBase", "BiRNN",
    "BeamSearchDecoder", "dynamic_decode",
]

RNNCellBase = _RNNCellBase


class ZeroPad1D(_PadND):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class ZeroPad3D(_PadND):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class Softmax2D(Layer):
    """Softmax over the channel axis of ``[..., C, H, W]``."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class _ArgsLayer(Layer):
    """A layer holding its functional's trailing arguments in ``_args``."""

    _fn = None

    def __init__(self, *args):
        super().__init__()
        self._args = args

    def forward(self, *inputs):
        return type(self)._fn(*inputs, *self._args)


class _UnpoolND(_ArgsLayer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format=None, output_size=None,
                 name=None):
        super().__init__(kernel_size, stride, padding, output_size)


class MaxUnPool1D(_UnpoolND):
    _fn = F.max_unpool1d


class MaxUnPool2D(_UnpoolND):
    _fn = F.max_unpool2d


class MaxUnPool3D(_UnpoolND):
    _fn = F.max_unpool3d


class LPPool1D(_ArgsLayer):
    _fn = F.lp_pool1d

    def __init__(self, norm_type, kernel_size, stride=None, ceil_mode=False, data_format="NCL",
                 name=None):
        super().__init__(norm_type, kernel_size, stride, ceil_mode)


class LPPool2D(_ArgsLayer):
    _fn = F.lp_pool2d

    def __init__(self, norm_type, kernel_size, stride=None, ceil_mode=False,
                 data_format="NCHW", name=None):
        super().__init__(norm_type, kernel_size, stride, ceil_mode)


class FractionalMaxPool2D(_ArgsLayer):
    _fn = F.fractional_max_pool2d

    def __init__(self, output_size, kernel_size=None, random_u=None, return_mask=False,
                 name=None):
        super().__init__(output_size, kernel_size, random_u, return_mask)


class FractionalMaxPool3D(FractionalMaxPool2D):
    _fn = F.fractional_max_pool3d


class AdaptiveMaxPool3D(_ArgsLayer):
    _fn = F.adaptive_max_pool3d

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)


class FeatureAlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__(generator=generator)
        self._p = p

    def forward(self, x):
        return F.feature_alpha_dropout(x, self._p, training=self.training,
                                       generator=self._generator)


class MultiMarginLoss(_ArgsLayer):
    _fn = F.multi_margin_loss

    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean", name=None):
        super().__init__(p, margin, weight, reduction)


class TripletMarginWithDistanceLoss(_ArgsLayer):
    _fn = F.triplet_margin_with_distance_loss

    def __init__(self, distance_function=None, margin=1.0, swap=False, reduction="mean",
                 name=None):
        super().__init__(distance_function, margin, swap, reduction)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self._num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size], attr=weight_attr)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_classes - 1], attr=bias_attr, is_bias=True))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight, self.bias,
                               path_table, path_code)


class RNNTLoss(Layer):
    def __init__(self, blank=0, fastemit_lambda=0.0, reduction="mean", name=None):
        super().__init__()
        self._args = (blank, fastemit_lambda, reduction)

    def forward(self, input, label, input_lengths, label_lengths):
        return F.rnnt_loss(input, label, input_lengths, label_lengths, *self._args)


class AdaptiveLogSoftmaxWithLoss(Layer):
    """Adaptive softmax with its own head and tail parameters (tail
    cluster ``i`` projects to ``in_features / div_value ** (i + 1)``)."""

    def __init__(self, in_features, n_classes, cutoffs, div_value=4.0, head_bias=False,
                 name=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        self._cutoffs = list(cutoffs)
        self._n_classes = n_classes
        head_size = self._cutoffs[0] + len(self._cutoffs)
        self.head_weight = self.create_parameter([in_features, head_size])
        self.head_bias = (self.create_parameter([head_size], is_bias=True) if head_bias
                          else None)
        bounds = self._cutoffs + [n_classes]
        for i in range(len(self._cutoffs)):
            proj = max(1, int(in_features / (div_value ** (i + 1))))
            self.register_parameter(f"tail_{i}_proj", self.create_parameter([in_features, proj]))
            self.register_parameter(f"tail_{i}_out", self.create_parameter(
                [proj, bounds[i + 1] - bounds[i]]))

    def forward(self, input, label):
        tails = [(getattr(self, f"tail_{i}_proj"), getattr(self, f"tail_{i}_out"))
                 for i in range(len(self._cutoffs))]
        return F.adaptive_log_softmax_with_loss(input, label, self.head_weight, tails,
                                                self._cutoffs, head_bias=self.head_bias)


class LayerDict(Layer, nn.ModuleDict):
    """Ordered dict of sublayers."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers:
            self.update(sublayers)


class ParameterDict(Layer, nn.ParameterDict):
    """Ordered dict of parameters (a port ``Parameter`` is stored as its
    ``torch.nn.Parameter``)."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters:
            pairs = parameters.items() if isinstance(parameters, dict) else parameters
            for k, v in pairs:
                self[k] = v

    def __setitem__(self, key, param):
        nn.ParameterDict.__setitem__(self, key, unwrap(param))


class BiRNN(Layer):
    """A forward and a reverse :class:`~.rnn.RNN` over two cells, outputs
    concatenated on the last axis; states ``(forward, backward)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False, name=None):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (initial_states if initial_states is not None
                                else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class BeamSearchDecoder:
    """Beam search over a cell: a step's scores are the log-softmax of
    ``output_fn(cell_out)``, beams kept by total log-probability.  Run by
    :func:`dynamic_decode`."""

    def __init__(self, cell, start_token, end_token, beam_size, embedding_fn=None,
                 output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _map_states(states, fn):
    if states is None:
        return None
    if isinstance(states, (tuple, list)):
        return type(states)(_map_states(s, fn) for s in states)
    return fn(unwrap(states))


def dynamic_decode(decoder: BeamSearchDecoder, inits=None, max_step_num=32, **kwargs):
    """Run beam search: returns ``(ids [B, beam, T] int32, scores [B,
    beam] fp32)``.  ``inits`` are the cell's initial states (batch major);
    every beam of a row starts from its row's state.  The cell, embedding
    and output functions are called with Tensors, as in the JAX package; the
    beam bookkeeping runs on the host in float64 over the step's fp32
    log-probabilities."""
    K, end = decoder.beam_size, decoder.end_token

    def emb(tokens):
        t = wrap(torch.as_tensor(tokens, dtype=torch.int32, device=device))
        return decoder.embedding_fn(t) if decoder.embedding_fn else t

    device = next((unwrap(s).device for s in _flat(inits)), None) or _cell_device(decoder.cell)
    out, _ = decoder.cell(emb(np.asarray([decoder.start_token])), wrap(inits))
    B = 1 if out.ndim == 1 else out.shape[0]
    tokens = np.full((B * K,), decoder.start_token, np.int32)
    live = np.where(np.arange(B * K) % K == 0, 0.0, -1e30)
    seqs = np.zeros((B * K, 0), np.int32)
    finished = np.zeros((B * K,), bool)
    states = _map_states(inits, lambda s: s.repeat_interleave(K, dim=0))
    for _ in range(max_step_num):
        out, new_states = decoder.cell(emb(tokens), wrap(states))
        logits = unwrap(decoder.output_fn(out) if decoder.output_fn else out)
        logp = torch.log_softmax(logits.detach().float(), dim=-1).cpu().numpy()   # [B K, V]
        V = logp.shape[-1]
        # a finished beam extends only with end_token, at no cost
        logp = np.where(finished[:, None], np.where(np.arange(V)[None, :] == end, 0.0, -1e30),
                        logp)
        total = (live[:, None] + logp).reshape(B, K * V)
        top = np.argsort(-total, axis=-1)[:, :K]
        src = (np.arange(B)[:, None] * K + top // V).reshape(-1)
        new_tok = (top % V).astype(np.int32).reshape(-1)
        seqs = np.concatenate([seqs[src], new_tok[:, None]], axis=1)
        live = np.take_along_axis(total, top, -1).reshape(-1)
        finished = finished[src] | (new_tok == end)
        tokens = new_tok
        sel = torch.as_tensor(src, device=device)
        states = _map_states(new_states, lambda s: s[sel])
        if finished.all():
            break
    return (wrap(torch.from_numpy(seqs.reshape(B, K, -1)).to(device)),
            wrap(torch.from_numpy(live.reshape(B, K).astype(np.float32)).to(device)))


def _flat(states) -> List:
    if states is None:
        return []
    if isinstance(states, (tuple, list)):
        return [x for s in states for x in _flat(s)]
    return [states]


def _cell_device(cell):
    p = next(iter(cell.parameters()), None) if isinstance(cell, nn.Module) else None
    return p.device if p is not None else torch.device("cpu")
