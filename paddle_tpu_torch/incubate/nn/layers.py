"""Fused transformer layers (port of ``paddle_tpu/incubate/nn/layers.py``):
parameter-holding wrappers over :mod:`.functional`, with the JAX layers'
parameter names and shapes (so ``models.convert`` carries their weights
across) and their initialisers: Xavier-uniform weights, zero biases, unit
norm scales.  ``device`` defaults to CUDA (raising without a card), as
every entry point of the port; weights come from a generator seeded with
``seed``, which also draws the layer's dropout masks."""

from __future__ import annotations

import math

import torch
from torch import nn

from ... import default_device, make_generator
from ...nn.initializer import fans
from . import functional as F

__all__ = ["FusedLinear", "FusedDropoutAdd", "FusedBiasDropoutResidualLayerNorm",
           "FusedMultiHeadAttention", "FusedFeedForward", "FusedTransformerEncoderLayer",
           "FusedMultiTransformer"]


class _Fused(nn.Module):
    """Parameter factory of the fused layers."""

    def __init__(self, device=None, seed: int = 0):
        super().__init__()
        self._device = default_device(device)
        self.generator = make_generator(seed, self._device)

    def _xavier(self, shape):
        fi, fo = fans(shape)
        limit = math.sqrt(6.0 / (fi + fo))
        t = torch.empty(shape, dtype=torch.float32, device=self._device)
        return nn.Parameter(t.uniform_(-limit, limit, generator=self.generator))

    def _const(self, shape, value):
        return nn.Parameter(torch.full(shape, float(value), dtype=torch.float32,
                                       device=self._device))


class FusedLinear(_Fused):
    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 transpose_weight=False, name=None, *, device=None, seed=0):
        super().__init__(device, seed)
        self.transpose_weight = transpose_weight
        shape = [out_features, in_features] if transpose_weight else [in_features, out_features]
        self.weight = self._xavier(shape)
        self.bias = self._const([out_features], 0.0) if bias_attr is not False else None

    def forward(self, x):
        return F.fused_linear(x, self.weight, self.bias, transpose_weight=self.transpose_weight)


class FusedDropoutAdd(_Fused):
    def __init__(self, p=0.5, mode="upscale_in_train", name=None, *, device=None, seed=0):
        super().__init__(device, seed)
        self.p, self.mode = p, mode

    def forward(self, x, y):
        return F.fused_dropout_add(x, y, p=self.p, training=self.training, mode=self.mode,
                                   generator=self.generator)


class FusedBiasDropoutResidualLayerNorm(_Fused):
    def __init__(self, embed_dim, dropout_rate=0.5, weight_attr=None, bias_attr=None,
                 epsilon=1e-5, name=None, *, device=None, seed=0):
        super().__init__(device, seed)
        self.dropout_rate, self.epsilon = dropout_rate, epsilon
        self.linear_bias = self._const([embed_dim], 0.0)
        self.ln_scale = self._const([embed_dim], 1.0)
        self.ln_bias = self._const([embed_dim], 0.0)

    def forward(self, x, residual):
        return F.fused_bias_dropout_residual_layer_norm(
            x, residual, bias=self.linear_bias, ln_scale=self.ln_scale, ln_bias=self.ln_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self.epsilon, training=self.training,
            generator=self.generator)


class FusedMultiHeadAttention(_Fused):
    """Self-attention block with fused qkv ``[3, H, D, E]``;
    ``normalize_before`` picks pre- or post-LN."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5, attn_dropout_rate=0.5,
                 kdim=None, vdim=None, normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None, linear_weight_attr=None,
                 linear_bias_attr=None, pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-5, nranks=1, ring_id=-1,
                 name=None, *, device=None, seed=0):
        super().__init__(device, seed)
        if embed_dim % num_heads:
            raise ValueError("embed_dim must divide num_heads")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.dropout_rate = dropout_rate
        self.attn_dropout_rate = attn_dropout_rate
        self.epsilon = epsilon
        self.qkv_weight = self._xavier([3, num_heads, self.head_dim, embed_dim])
        self.qkv_bias = self._const([3, num_heads, self.head_dim], 0.0)
        self.linear_weight = self._xavier([embed_dim, embed_dim])
        self.linear_bias = self._const([embed_dim], 0.0)
        self.pre_ln_scale = self._const([embed_dim], 1.0)
        self.pre_ln_bias = self._const([embed_dim], 0.0)
        self.ln_scale = self._const([embed_dim], 1.0)
        self.ln_bias = self._const([embed_dim], 0.0)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        return F.fused_multi_head_attention(
            query, self.qkv_weight, self.linear_weight, pre_layer_norm=self.normalize_before,
            pre_ln_scale=self.pre_ln_scale, pre_ln_bias=self.pre_ln_bias,
            ln_scale=self.ln_scale, ln_bias=self.ln_bias, pre_ln_epsilon=self.epsilon,
            qkv_bias=self.qkv_bias, linear_bias=self.linear_bias, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate, attn_dropout_rate=self.attn_dropout_rate,
            ln_epsilon=self.epsilon, training=self.training, num_heads=self.num_heads,
            generator=self.generator)


class FusedFeedForward(_Fused):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1, epsilon=1e-5,
                 activation="relu", act_dropout_rate=None, normalize_before=False,
                 linear1_weight_attr=None, linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None, ln1_bias_attr=None,
                 ln2_scale_attr=None, ln2_bias_attr=None, nranks=1, ring_id=-1, name=None,
                 *, device=None, seed=0):
        super().__init__(device, seed)
        self.normalize_before = normalize_before
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.act_dropout_rate = dropout_rate if act_dropout_rate is None else act_dropout_rate
        self.epsilon = epsilon
        self.linear1_weight = self._xavier([d_model, dim_feedforward])
        self.linear1_bias = self._const([dim_feedforward], 0.0)
        self.linear2_weight = self._xavier([dim_feedforward, d_model])
        self.linear2_bias = self._const([d_model], 0.0)
        self.ln1_scale = self._const([d_model], 1.0)
        self.ln1_bias = self._const([d_model], 0.0)
        self.ln2_scale = self._const([d_model], 1.0)
        self.ln2_bias = self._const([d_model], 0.0)

    def forward(self, x):
        return F.fused_feedforward(
            x, self.linear1_weight, self.linear2_weight, linear1_bias=self.linear1_bias,
            linear2_bias=self.linear2_bias, ln1_scale=self.ln1_scale, ln1_bias=self.ln1_bias,
            ln2_scale=self.ln2_scale, ln2_bias=self.ln2_bias,
            dropout1_rate=self.act_dropout_rate, dropout2_rate=self.dropout_rate,
            activation=self.activation, ln1_epsilon=self.epsilon, ln2_epsilon=self.epsilon,
            pre_layer_norm=self.normalize_before, training=self.training,
            generator=self.generator)


class FusedTransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1, activation="relu",
                 attn_dropout_rate=None, act_dropout_rate=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, *, device=None, seed=0):
        super().__init__()
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate if attn_dropout_rate is None else attn_dropout_rate,
            normalize_before=normalize_before, device=device, seed=seed)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate, activation=activation,
            act_dropout_rate=act_dropout_rate, normalize_before=normalize_before,
            device=device, seed=seed + 1)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(_Fused):
    """A pre-LN decoder stack; its per-layer parameters are named
    ``<list>_<i>`` (``qkv_weights_0``, ...) as in the JAX layer."""

    _LISTS = ("ln_scales", "ln_biases", "qkv_weights", "qkv_biases", "linear_weights",
              "linear_biases", "ffn_ln_scales", "ffn_ln_biases", "ffn1_weights",
              "ffn1_biases", "ffn2_weights", "ffn2_biases")

    def __init__(self, embed_dim, num_heads, dim_feedforward, dropout_rate=0.0,
                 activation="gelu", normalize_before=True, num_layers=-1, epsilon=1e-5,
                 nranks=1, ring_id=-1, name=None, *, device=None, seed=0, **attr_kwargs):
        super().__init__(device, seed)
        if not normalize_before:
            raise ValueError("FusedMultiTransformer is pre-LN (normalize_before=True), as in "
                             "the reference")
        if num_layers <= 0:
            raise ValueError("num_layers must be positive")
        self.activation = activation
        self.dropout_rate = dropout_rate
        self.epsilon = epsilon
        head_dim = embed_dim // num_heads
        E, H, D, Fd = embed_dim, num_heads, head_dim, dim_feedforward
        for attr in self._LISTS:
            setattr(self, attr, [])
        for _ in range(num_layers):
            made = {"ln_scales": self._const([E], 1.0), "ln_biases": self._const([E], 0.0),
                    "qkv_weights": self._xavier([3, H, D, E]),
                    "qkv_biases": self._const([3, H, D], 0.0),
                    "linear_weights": self._xavier([E, E]),
                    "linear_biases": self._const([E], 0.0),
                    "ffn_ln_scales": self._const([E], 1.0),
                    "ffn_ln_biases": self._const([E], 0.0),
                    "ffn1_weights": self._xavier([E, Fd]), "ffn1_biases": self._const([Fd], 0.0),
                    "ffn2_weights": self._xavier([Fd, E]), "ffn2_biases": self._const([E], 0.0)}
            for attr in self._LISTS:
                getattr(self, attr).append(made[attr])
        for attr in self._LISTS:
            for i, p in enumerate(getattr(self, attr)):
                self.register_parameter(f"{attr}_{i}", p)

    def forward(self, x, attn_mask=None, caches=None, pre_caches=None, rotary_embs=None,
                time_step=None, seq_lens=None):
        return F.fused_multi_transformer(
            x, *(getattr(self, attr) for attr in self._LISTS), pre_layer_norm=True,
            epsilon=self.epsilon, cache_kvs=caches, attn_mask=attn_mask,
            dropout_rate=self.dropout_rate, activation=self.activation,
            training=self.training, generator=self.generator)
