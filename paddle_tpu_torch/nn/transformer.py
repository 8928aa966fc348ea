"""Transformer layers (port of ``paddle_tpu/nn/transformer.py``).

:class:`MultiHeadAttention` runs ``functional.scaled_dot_product_attention``
on ``[batch, seq, heads, head_dim]``: the flash kernels when there is no
mask and the head dim is one they take, the plain reference otherwise.  As
in the JAX package, two things differ from Paddle: no dropout is applied
to the attention probabilities (the JAX ``scaled_dot_product_attention``
ignores ``dropout_p``), and ``TransformerEncoder`` / ``TransformerDecoder``
deep-copy the layer they are given, so every layer starts from the same
weights (the copies draw dropout masks from the same generator).
"""

from __future__ import annotations

import numpy as np
import torch

from . import functional as F
from .common_layers import Dropout, Linear
from .layers import Layer, LayerList, deepcopy_sharing_generators
from .norm import LayerNorm

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder", "Transformer"]


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, *, device=None,
                 generator=None):
        super().__init__(device=device, generator=generator)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout, self.need_weights = dropout, need_weights
        kw = dict(generator=self.generator)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, **kw)

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def _heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        return self.Cache(self._heads(self.k_proj(key)),
                          self._heads(self.v_proj(key if value is None else value)))

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._heads(self.q_proj(query))
        k, v = self._heads(self.k_proj(key)), self._heads(self.v_proj(value))
        if cache is not None:
            k, v = torch.cat([cache.k, k], dim=1), torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout if self.training else 0.0,
            is_causal=False, training=self.training)
        out = self.out_proj(out.reshape(query.shape[0], query.shape[1], self.embed_dim))
        return out if cache is None else (out, cache)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, layer_norm_eps=1e-5, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(generator=self.generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1, self.dropout2 = Dropout(dropout, **kw), Dropout(dropout, **kw)
        self.act_dropout = Dropout(act_dropout, **kw)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([deepcopy_sharing_generators(encoder_layer)
                                 for _ in range(num_layers)])
        self.num_layers, self.norm = num_layers, norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, layer_norm_eps=1e-5, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(generator=self.generator)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr, bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.norm3 = LayerNorm(d_model, epsilon=layer_norm_eps, **kw)
        self.dropout1, self.dropout2 = Dropout(dropout, **kw), Dropout(dropout, **kw)
        self.dropout3 = Dropout(dropout, **kw)
        self.act_dropout = Dropout(act_dropout, **kw)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = residual + self.dropout1(self.self_attn(tgt, tgt, tgt, tgt_mask))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = residual + self.dropout2(self.cross_attn(tgt, memory, memory, memory_mask))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([deepcopy_sharing_generators(decoder_layer)
                                 for _ in range(num_layers)])
        self.num_layers, self.norm = num_layers, norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output = tgt
        for mod in self.layers:
            output = mod(output, memory, tgt_mask, memory_mask)
        if self.norm is not None:
            output = self.norm(output)
        return output


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None, generator=None):
        super().__init__(device=device, generator=generator)
        kw = dict(generator=self.generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation, attn_dropout,
                act_dropout, normalize_before, weight_attr, bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        return self.decoder(tgt, self.encoder(src, src_mask), tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        return torch.from_numpy(np.triu(np.full((length, length), -np.inf, dtype=np.float32),
                                        k=1))
