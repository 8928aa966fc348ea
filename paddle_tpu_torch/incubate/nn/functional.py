"""Fused functional ops (port of ``paddle_tpu/incubate/nn/functional.py``).

Three reach the port's kernels: :func:`fused_rms_norm` (``kernels.rms_norm``),
:func:`masked_multihead_attention` (the dense decode kernel) and
:func:`block_multihead_attention` (its pools gathered to a dense cache, then
the dense decode kernel, as the JAX package gathers before its decode
call).  :func:`swiglu` and :func:`fused_rotary_position_embedding` are the
port's plain copies (``kernels/swiglu.py``, ``kernels/rope.py``), as their
JAX originals are plain XLA.  The transformer family, :func:`fused_moe` and
:func:`variable_length_memory_efficient_attention` are stock torch
compositions, as they are jnp compositions there.

Weights follow the JAX package's layouts (``[in, out]`` linears, ``qkv``
``[3, H, D, E]``).  Dropout keeps Paddle's two modes: ``upscale_in_train``
(kept values divided by ``1 - p`` in training, identity at inference) and
``downscale_in_infer`` (kept values as they are in training, scaled by ``1
- p`` at inference).  Its masks come from the explicit ``torch.Generator``
the caller passes (the fused layers pass their own); a draw without one
raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ...kernels import decode_attention as _da
from ...kernels import rms_norm as _rms
from ...kernels import rope as _rope
from ...kernels import swiglu as _swiglu

__all__ = ["fused_rms_norm", "fused_layer_norm", "swiglu", "fused_rotary_position_embedding",
           "fused_bias_act", "fused_linear", "fused_dropout_add",
           "masked_multihead_attention", "block_multihead_attention",
           "fused_matmul_bias", "fused_linear_activation",
           "fused_bias_dropout_residual_layer_norm", "fused_feedforward",
           "fused_multi_head_attention", "fused_multi_transformer",
           "fused_moe", "variable_length_memory_efficient_attention",
           "blha_get_max_len", "dropout"]


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator: Optional[torch.Generator] = None):
    """Paddle's dropout: ``upscale_in_train`` or ``downscale_in_infer``;
    the mask is drawn from ``generator``."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training:
        return x * (1.0 - p) if mode == "downscale_in_infer" else x
    if p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training with p > 0 draws a mask: pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype, device=x.device))


def _activation(name):
    if name in (None, "none", ""):
        return lambda t: t
    return getattr(F, name)


def _layer_norm(x, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last dim, statistics in fp32 (the JAX package's)."""
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def fused_rms_norm(x, norm_weight=None, norm_bias=None, epsilon=1e-6, begin_norm_axis=-1,
                   bias=None, residual=None, quant_scale=-1, **kw):
    """RMSNorm over the last dim through ``kernels.rms_norm`` (the CUDA
    kernel for a CUDA ``x``).  As in the JAX package, ``norm_bias``,
    ``bias``, ``residual`` and ``quant_scale`` are accepted and not applied."""
    return _rms.rms_norm(x, norm_weight, epsilon)


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5, begin_norm_axis=1, **kw):
    return _layer_norm(x, norm_weight, norm_bias, epsilon)


def swiglu(x, y=None, name=None):
    return _swiglu.swiglu(x, y)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None, position_ids=None,
                                    use_neox_rotary_style=True, time_major=False,
                                    rotary_emb_base=10000.0):
    return _rope.fused_rotary_position_embedding(q, k, v, sin=sin, cos=cos,
                                                 position_ids=position_ids,
                                                 use_neox_rotary_style=use_neox_rotary_style)


def fused_bias_act(x, bias=None, dequant_scales=None, shift=None, smooth=None,
                   act_method="gelu", **kw):
    out = x if bias is None else x + bias
    if act_method in ("swiglu", "geglu"):
        return swiglu(out)
    return _activation(act_method)(out)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    w = weight.T if transpose_weight else weight
    out = x @ w
    return out if bias is None else out + bias


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train", name=None,
                      generator=None):
    return dropout(x, p, training, mode, generator) + y


def masked_multihead_attention(q, k_cache, v_cache, lengths, sm_scale=None):
    """Single-token decode attention over a dense KV cache: q ``[B, 1, H,
    D]``, caches ``[B, C, Hk, D]``, ``lengths`` ``[B]`` (valid slots, the
    current token included).  The dense decode kernel on CUDA tensors."""
    return _da.masked_multihead_attention(q, k_cache, v_cache, lengths, sm_scale=sm_scale)


def block_multihead_attention(q, k_blocks, v_blocks, block_table, lengths, sm_scale=None):
    """Decode attention over a paged cache in the JAX package's pool layout
    ``[NB, bs, Hk, D]``: each row's blocks (``block_table`` ``[B, MAXB]``)
    gathered to a dense ``[B, MAXB * bs, Hk, D]`` cache, then the dense
    decode kernel.  (The serving pools, ``[NB, Hk, bs, D]``, go to
    ``kernels.decode_attention.paged_decode_attention`` instead.)"""
    B = q.shape[0]
    _, _, hk, d = k_blocks.shape
    tbl = torch.as_tensor(block_table, device=q.device).long()
    k = k_blocks[tbl].reshape(B, -1, hk, d)
    v = v_blocks[tbl].reshape(B, -1, hk, d)
    return masked_multihead_attention(q, k, v, lengths, sm_scale=sm_scale)


# ---------------------------------------------------------------------------
# the fused transformer family: stock torch compositions
# ---------------------------------------------------------------------------

def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False, name=None):
    a = x.transpose(-1, -2) if transpose_x else x
    b = y.transpose(-1, -2) if transpose_y else y
    out = a @ b
    return out if bias is None else out + bias


def fused_linear_activation(x, y, bias, trans_x=False, trans_y=False, activation="gelu",
                            name=None):
    return _activation(activation)(fused_matmul_bias(x, y, bias, trans_x, trans_y))


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None, ln_scale=None,
                                           ln_bias=None, dropout_rate=0.5, ln_epsilon=1e-5,
                                           training=True, mode="upscale_in_train", name=None,
                                           generator=None):
    """``layer_norm(residual + dropout(x + bias))``."""
    h = x if bias is None else x + bias
    h = residual + dropout(h, dropout_rate, training, mode, generator)
    return _layer_norm(h, ln_scale, ln_bias, ln_epsilon)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None, linear2_bias=None,
                      ln1_scale=None, ln1_bias=None, ln2_scale=None, ln2_bias=None,
                      dropout1_rate=0.5, dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5, pre_layer_norm=False,
                      training=True, mode="upscale_in_train", ring_id=-1, name=None,
                      generator=None):
    """Transformer FFN block, the norm before (``pre_layer_norm``) or after
    the residual add."""
    h = x
    if pre_layer_norm:
        h = _layer_norm(h, ln1_scale, ln1_bias, ln1_epsilon)
    h = fused_linear(h, linear1_weight, linear1_bias)
    h = dropout(_activation(activation)(h), dropout1_rate, training, mode, generator)
    h = fused_linear(h, linear2_weight, linear2_bias)
    h = x + dropout(h, dropout2_rate, training, mode, generator)
    if not pre_layer_norm:
        h = _layer_norm(h, ln2_scale, ln2_bias, ln2_epsilon)
    return h


def _self_attention_core(q, k, v, attn_mask, attn_dropout_rate, training, mode, generator):
    d = q.shape[-1]
    s = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32), k.to(torch.float32))
    s = s / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    if attn_mask is not None:
        s = s + attn_mask.to(torch.float32)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = dropout(p, attn_dropout_rate, training, mode, generator)
    return torch.einsum("bhst,bhtd->bhsd", p, v)


def fused_multi_head_attention(x, qkv_weight, linear_weight, pre_layer_norm=False,
                               pre_ln_scale=None, pre_ln_bias=None, ln_scale=None, ln_bias=None,
                               pre_ln_epsilon=1e-5, qkv_bias=None, linear_bias=None,
                               cache_kv=None, attn_mask=None, dropout_rate=0.5,
                               attn_dropout_rate=0.5, ln_epsilon=1e-5, training=True,
                               mode="upscale_in_train", ring_id=-1, add_residual=True,
                               num_heads=-1, transpose_qkv_wb=False, name=None,
                               generator=None):
    """Self-attention block: optional pre-LN, fused qkv (``[3, H, D, E]``,
    or ``[E, 3E]`` with ``transpose_qkv_wb``), attention, out projection,
    bias + dropout + residual (and post-LN)."""
    B, S, E = x.shape
    h = x
    if pre_layer_norm:
        h = _layer_norm(h, pre_ln_scale, pre_ln_bias, pre_ln_epsilon)
    if transpose_qkv_wb:
        if num_heads <= 0:
            raise ValueError("num_heads must be given with transpose_qkv_wb")
        nh, hd = num_heads, E // num_heads
        qkv = h @ qkv_weight
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
        qkv = qkv.reshape(B, S, 3, nh, hd)
    else:
        nh, hd = int(qkv_weight.shape[1]), int(qkv_weight.shape[2])
        qkv = torch.einsum("bse,khde->bskhd", h, qkv_weight)
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
    q, k, v = qkv.permute(2, 0, 3, 1, 4)                        # [B, H, S, D] each
    ctx = _self_attention_core(q, k, v, attn_mask, attn_dropout_rate, training, mode,
                               generator)
    out = ctx.permute(0, 2, 1, 3).reshape(B, S, nh * hd) @ linear_weight
    if add_residual:
        if pre_layer_norm:
            out = out if linear_bias is None else out + linear_bias
            return x + dropout(out, dropout_rate, training, mode, generator)
        return fused_bias_dropout_residual_layer_norm(
            out, x, bias=linear_bias, ln_scale=ln_scale, ln_bias=ln_bias,
            dropout_rate=dropout_rate, ln_epsilon=ln_epsilon, training=training, mode=mode,
            generator=generator)
    if linear_bias is not None:
        out = out + linear_bias
    out = dropout(out, dropout_rate, training, mode, generator)
    if not pre_layer_norm:
        out = _layer_norm(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights, qkv_biases, linear_weights,
                            linear_biases, ffn_ln_scales, ffn_ln_biases, ffn1_weights,
                            ffn1_biases, ffn2_weights, ffn2_biases, pre_layer_norm=True,
                            epsilon=1e-5, cache_kvs=None, pre_caches=None, rotary_embs=None,
                            time_step=None, attn_mask=None, dropout_rate=0.0,
                            activation="gelu", training=False, mode="upscale_in_train",
                            trans_qkvw=True, ring_id=-1, name=None, generator=None):
    """A pre-LN decoder stack in one call: per layer LN, qkv, attention,
    projection (+ residual), then the FFN with its own LN.  ``cache_kvs`` are
    returned as given (no incremental decode here, as in the JAX package)."""
    def at(seq, i):
        return seq[i] if seq else None

    h = x
    for i in range(len(qkv_weights)):
        h = fused_multi_head_attention(
            h, qkv_weights[i], linear_weights[i], pre_layer_norm=pre_layer_norm,
            pre_ln_scale=at(ln_scales, i), pre_ln_bias=at(ln_biases, i),
            pre_ln_epsilon=epsilon, qkv_bias=at(qkv_biases, i),
            linear_bias=at(linear_biases, i), attn_mask=attn_mask, dropout_rate=dropout_rate,
            attn_dropout_rate=dropout_rate, training=training, mode=mode, generator=generator)
        h = fused_feedforward(
            h, ffn1_weights[i], ffn2_weights[i], linear1_bias=at(ffn1_biases, i),
            linear2_bias=at(ffn2_biases, i), ln1_scale=at(ffn_ln_scales, i),
            ln1_bias=at(ffn_ln_biases, i), ln1_epsilon=epsilon, dropout1_rate=dropout_rate,
            dropout2_rate=dropout_rate, activation=activation, pre_layer_norm=pre_layer_norm,
            training=training, mode=mode, generator=generator)
    return (h, cache_kvs) if cache_kvs is not None else h


def fused_moe(x, gate_weight, ffn1_weights, ffn1_biases, ffn2_weights, ffn2_biases, top_k=2,
              norm_topk_prob=True, name=None):
    """Dense MoE FFN: softmax top-k routing (no capacity), each expert's
    FFN (tanh-approximated GELU, ``jax.nn.gelu``'s default, as in the JAX
    package) on every token, the outputs weighted by the routing (the
    capacity-bounded form is :mod:`..moe`)."""
    B, S, _ = x.shape
    probs = torch.softmax((x @ gate_weight).to(torch.float32), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]
    topv = torch.gather(probs, -1, idx)
    if norm_topk_prob:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    weight = torch.zeros_like(probs).scatter(-1, idx, topv)               # [B, S, X]
    up = F.gelu(torch.einsum("bse,xeh->bsxh", x, ffn1_weights) + ffn1_biases,
                approximate="tanh")
    down = torch.einsum("bsxh,xhe->bsxe", up, ffn2_weights) + ffn2_biases
    return torch.einsum("bsxe,bsx->bse", down, weight.to(x.dtype))


def variable_length_memory_efficient_attention(query, key, value, seq_lens, kv_seq_lens,
                                               mask=None, scale=None, causal=False,
                                               pre_cache_length=0, name=None):
    """Attention over padded batches ``[B, H, S, D]``: keys past a row's
    ``kv_seq_lens`` masked out, queries past its ``seq_lens`` zero."""
    B, H, S, D = query.shape
    T = key.shape[2]
    sl = torch.as_tensor(seq_lens, device=query.device).reshape(-1)
    kl = torch.as_tensor(kv_seq_lens, device=query.device).reshape(-1)
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bhsd,bhtd->bhst", query.to(torch.float32),
                          key.to(torch.float32)) * s
    kv_valid = torch.arange(T, device=query.device)[None, :] < kl[:, None]
    scores = torch.where(kv_valid[:, None, None, :], scores, -math.inf)
    if causal:
        tri = torch.ones(S, T, dtype=torch.bool, device=query.device).tril()
        scores = torch.where(tri[None, None], scores, -math.inf)
    if mask is not None:
        scores = scores + mask.to(torch.float32)
    p = torch.nan_to_num(torch.softmax(scores, dim=-1), nan=0.0)
    out = torch.einsum("bhst,bhtd->bhsd", p, value.to(torch.float32))
    q_valid = torch.arange(S, device=query.device)[None, :] < sl[:, None]
    return torch.where(q_valid[:, None, :, None], out, 0.0).to(query.dtype)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size, name=None):
    """``(max encoder length, max decoder length)`` as 0-d tensors."""
    return (torch.as_tensor(seq_lens_encoder).max(), torch.as_tensor(seq_lens_decoder).max())
