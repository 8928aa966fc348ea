"""Llama decoder family (port of ``paddle_tpu/models/llama.py``).

Same configuration, same parameter names (``state_dict()`` keys are the JAX
names, e.g. ``llama.layers.0.self_attn.qkv_proj``), same weight layout
``[in, out]`` with ``x @ w``, and the same three attention cache modes:

- no cache: the plain causal GQA attention reference;
- dense ``(k, v, offset)``: prefill and ``generate``; decode steps run the
  dense decode kernel (:func:`masked_multihead_attention`);
- paged ``(k_pool, v_pool, block_table, lengths)``: the serving Engine;
  single-token steps run the paged decode kernel, chunks the plain gather.

Caches are updated in place (the JAX versions return updated arrays that XLA
writes in place under donation); the updated tensors are also returned.

The no-cache forward (training) runs flash attention (the kernels of
``kernels/flash_attention.py``) when ``use_flash_attention`` is set, the
plain reference otherwise; ``recompute`` / ``recompute_layers`` checkpoint
decoder layers with ``torch.utils.checkpoint``.  ``compute_loss`` is the
shifted next-token cross-entropy in fp32.

Three seams take the fusion sites of ``kernels/emit.py`` while a table of
them is activated (``emit.activate``), read at every call: the SwiGLU MLP
(``mlp_fn``), the residual add + post-attention RMSNorm of each decoder
layer, and the final RMSNorm + vocab projection of
``LlamaForCausalLM.forward``.  As in the JAX model, the add-norm and head
seams are off with a cache, so ``generate`` and the Engine keep their stock
norms and head; ``mlp_fn`` reads the table whatever the cache.

MoE configs (``moe_num_experts > 1``) build :class:`~..incubate.moe.MoELayer`
as each layer's ``mlp``, as the JAX model does: its experts in
``config.dtype``, its router in fp32.  The no-cache forward threads each
layer's aux loss through recompute and keeps the total for
``compute_loss`` (``moe_aux_loss_weight * aux``); the gshard gate's draws
are taken before each layer runs, so a recomputed layer routes as its
forward did.  The cache paths drop the aux (serving never reads it).  None
of the three seams is taken with MoE, activated or not.

Left to a later slice, and refused with ``NotImplementedError`` when a
config asks for it: sharding (sequence / context parallel).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import default_device, make_generator, to_dtype
from ..framework.dispatch import amp_cast, checked
from ..framework.tensor import boundary, call_unwrapped
from ..distributed.parallel.mp_layers import _ce_no_gather
from ..incubate.moe import MoELayer
from ..kernels import decode_attention as da
from ..kernels import emit
from ..kernels import rope as rope_mod
from ..kernels.flash_attention import _attention_reference, flash_attention
from ..kernels.rms_norm import rms_norm

__all__ = [
    "LlamaConfig", "LlamaModel", "LlamaForCausalLM",
    "llama_tiny_config", "llama3_8b_config", "llama3_70b_config",
]

NEG_INF = -1e30


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: str = "float32"           # compute/activation dtype
    param_dtype: Optional[str] = None  # storage dtype; None -> ``dtype``
    sequence_parallel: bool = False
    use_flash_attention: bool = True
    context_parallel_axis: Optional[str] = None
    recompute: bool = False
    recompute_layers: Optional[int] = None
    moe_num_experts: int = 1
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_gate: str = "gshard"
    moe_aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def pdtype(self) -> str:
        return self.param_dtype or self.dtype


def llama_tiny_config(**overrides) -> LlamaConfig:
    cfg = dict(vocab_size=512, hidden_size=128, intermediate_size=384,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=256)
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def llama3_8b_config(**overrides) -> LlamaConfig:
    cfg = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
               max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def llama3_70b_config(**overrides) -> LlamaConfig:
    cfg = dict(vocab_size=128256, hidden_size=8192, intermediate_size=28672,
               num_hidden_layers=80, num_attention_heads=64, num_key_value_heads=8,
               max_position_embeddings=8192, rope_theta=500000.0, dtype="bfloat16")
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def _check_supported(cfg: LlamaConfig) -> None:
    if cfg.sequence_parallel or cfg.context_parallel_axis:
        raise NotImplementedError(
            "paddle_tpu_torch: sequence / context parallelism comes with the "
            "distributed slice")


def _param(shape, cfg: LlamaConfig, device, gen, std: Optional[float] = None):
    """Parameter in the storage dtype: N(0, std) from ``gen``, or ones."""
    t = torch.empty(shape, dtype=to_dtype(cfg.pdtype), device=device)
    if std is None:
        t.fill_(1.0)
    else:
        t.normal_(0.0, std, generator=gen)
    return nn.Parameter(t)


# ---------------------------------------------------------------------------
# attention functions over plain tensors
# ---------------------------------------------------------------------------

def _qkv(hidden, w_qkv, cfg: LlamaConfig):
    h, hk, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    B, S, _ = hidden.shape
    qkv = hidden @ w_qkv.to(hidden.dtype)
    q, k, v = torch.split(qkv, [h * d, hk * d, hk * d], dim=-1)
    return q.reshape(B, S, h, d), k.reshape(B, S, hk, d), v.reshape(B, S, hk, d)


def attention_fn(hidden, w_qkv, w_o, cos, sin, cfg: LlamaConfig, position_ids=None):
    """GQA attention without a cache: fused qkv, rope, causal attention —
    the flash kernels (native GQA) or the plain reference."""
    B, S, _ = hidden.shape
    h, hk, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = _qkv(hidden, w_qkv, cfg)
    q, k = rope_mod.apply_rope(q, k, cos, sin, position_ids)
    if cfg.use_flash_attention:
        o = flash_attention(q, k, v, causal=True)
    else:
        rep = h // hk
        o = _attention_reference(q, k.repeat_interleave(rep, dim=2),
                                 v.repeat_interleave(rep, dim=2), True, None,
                                 1.0 / math.sqrt(d))
    return o.reshape(B, S, h * d) @ w_o.to(hidden.dtype)


def cached_attention_fn(hidden, w_qkv, w_o, k_cache, v_cache, cos, sin,
                        offset: int, cfg: LlamaConfig):
    """GQA attention with a dense KV cache: writes the chunk's K/V at
    ``offset`` (in place), then attends — the dense decode kernel for S=1,
    the plain absolute-causal path otherwise."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    B, S, _ = hidden.shape
    q, k, v = _qkv(hidden, w_qkv, cfg)
    pos = (offset + torch.arange(S, device=hidden.device))[None, :].expand(B, S)
    q, k = rope_mod.apply_rope(q, k, cos, sin, pos)
    k_cache[:, offset:offset + S] = k.to(k_cache.dtype)
    v_cache[:, offset:offset + S] = v.to(v_cache.dtype)
    if S == 1:
        o = da.masked_multihead_attention(q, k_cache, v_cache, offset + 1)
    else:
        o = da.cached_attention_reference(q, k_cache, v_cache, offset)
    return o.reshape(B, S, h * d) @ w_o.to(hidden.dtype), k_cache, v_cache


def paged_attention_fn(hidden, w_qkv, w_o, k_pool, v_pool, block_table,
                       lengths, cos, sin, cfg: LlamaConfig):
    """Single-token GQA attention over paged pools ``[NB, Hk, bs, D]``:
    per-sequence positions from ``lengths``; the new token's K/V is appended
    in place, then the paged decode kernel attends (``lengths == 0`` marks an
    inactive slot, whose output is zero)."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    B, S, _ = hidden.shape
    q, k, v = _qkv(hidden, w_qkv, cfg)
    q, k = rope_mod.apply_rope(q, k, cos, sin, lengths.long()[:, None])
    da.write_paged_token(k_pool, v_pool, block_table, lengths, k, v)
    att_len = torch.where(lengths > 0, lengths + 1, 0).to(torch.int32)
    o = da.paged_decode_attention(q, k_pool, v_pool, block_table, att_len)
    return o.reshape(B, S, h * d) @ w_o.to(hidden.dtype), k_pool, v_pool


def paged_chunk_attention_fn(hidden, w_qkv, w_o, k_pool, v_pool, block_table,
                             lengths, cos, sin, cfg: LlamaConfig):
    """Multi-token chunk attention over paged pools (chunked prefill and
    prefix-hit suffix prefill): the chunk sits at positions
    ``lengths[b] .. lengths[b]+S-1`` (block-aligned context); its K/V is
    scattered in place first, then one gather attends context + chunk."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    B, S, _ = hidden.shape
    q, k, v = _qkv(hidden, w_qkv, cfg)
    pos = lengths.long()[:, None] + torch.arange(S, device=hidden.device)[None, :]
    q, k = rope_mod.apply_rope(q, k, cos, sin, pos)
    da.write_paged_chunk(k_pool, v_pool, block_table, lengths, k, v)
    o = da.paged_chunk_attention(q, k_pool, v_pool, block_table, lengths)
    return o.reshape(B, S, h * d) @ w_o.to(hidden.dtype), k_pool, v_pool


def mlp_fn(hidden, w_gate_up, w_down, intermediate_size: int):
    """SwiGLU MLP over raw tensors with the fused gate_up product."""
    fused = emit.active("fuse_swiglu_mlp")
    if fused is not None:
        return fused(hidden, w_gate_up, w_down, intermediate_size=intermediate_size)
    gu = hidden @ w_gate_up.to(hidden.dtype)
    gate, up = torch.split(gu, [intermediate_size, intermediate_size], dim=-1)
    return (F.silu(gate) * up) @ w_down.to(hidden.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class LlamaRMSNorm(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.weight = _param([config.hidden_size], config, device, gen)
        self.epsilon = config.rms_norm_eps

    def forward(self, x):
        x, w = amp_cast("rms_norm", (x, self.weight))
        return checked("rms_norm", rms_norm(x, w, self.epsilon))


class LlamaAttention(nn.Module):
    """GQA attention with fused qkv and rope, in three cache modes."""

    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        h, hk, d = config.num_attention_heads, config.kv_heads, config.head_dim
        std = config.initializer_range
        self.qkv_proj = _param([config.hidden_size, (h + 2 * hk) * d], config, device, gen, std)
        self.o_proj = _param([h * d, config.hidden_size], config, device, gen, std)

    def forward(self, x, cos, sin, position_ids=None, cache=None):
        """Under ``amp.auto_cast`` the inputs are cast by the JAX op names
        (``block_multihead_attention``, ``masked_multihead_attention``,
        ``scaled_dot_product_attention``); a KV cache is written in place
        and never cast."""
        cfg = self.config
        if isinstance(cache, tuple) and len(cache) == 4:
            k_p, v_p, tbl, lengths = cache
            x, w_qkv, w_o = amp_cast("block_multihead_attention",
                                     (x, self.qkv_proj, self.o_proj))
            fn = paged_chunk_attention_fn if x.shape[1] > 1 else paged_attention_fn
            out, nk, nv = checked("block_multihead_attention",
                                  fn(x, w_qkv, w_o, k_p, v_p, tbl, lengths, cos, sin, cfg))
            return out, (nk, nv)
        if cache is not None:
            k_c, v_c, offset = cache
            x, w_qkv, w_o, cos, sin = amp_cast("masked_multihead_attention",
                                               (x, self.qkv_proj, self.o_proj, cos, sin))
            out, nk, nv = checked("masked_multihead_attention", cached_attention_fn(
                x, w_qkv, w_o, k_c, v_c, cos, sin, offset, cfg))
            return out, (nk, nv)
        x, w_qkv, w_o, cos, sin = amp_cast("scaled_dot_product_attention",
                                           (x, self.qkv_proj, self.o_proj, cos, sin))
        return checked("scaled_dot_product_attention",
                       attention_fn(x, w_qkv, w_o, cos, sin, cfg, position_ids))


class LlamaMLP(nn.Module):
    """SwiGLU MLP with fused gate_up."""

    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        std = config.initializer_range
        self.gate_up_proj = _param([config.hidden_size, 2 * config.intermediate_size],
                                   config, device, gen, std)
        self.down_proj = _param([config.intermediate_size, config.hidden_size],
                                config, device, gen, std)
        self.intermediate_size = config.intermediate_size

    def forward(self, x):
        x, w_gu, w_d = amp_cast("swiglu_mlp", (x, self.gate_up_proj, self.down_proj))
        return checked("swiglu_mlp", mlp_fn(x, w_gu, w_d, self.intermediate_size))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.input_layernorm = LlamaRMSNorm(config, device, gen)
        self.self_attn = LlamaAttention(config, device, gen)
        self.post_attention_layernorm = LlamaRMSNorm(config, device, gen)
        self.is_moe = config.moe_num_experts > 1
        if self.is_moe:
            self.mlp = MoELayer(
                config.hidden_size, config.intermediate_size, config.moe_num_experts,
                top_k=config.moe_top_k, capacity_factor=config.moe_capacity_factor,
                gate=config.moe_gate, dtype=config.dtype, device=device, generator=gen,
                initializer_range=config.initializer_range)
        else:
            self.mlp = LlamaMLP(config, device, gen)

    def forward(self, x, cos, sin, position_ids=None, cache=None, uniforms=None):
        """Returns ``x`` (``(x, aux_loss)`` for MoE), or ``(x, (k, v))`` with
        a cache.  ``uniforms``: the MoE gshard gate's draws (drawn here when
        None)."""
        h = self.self_attn(self.input_layernorm(x), cos, sin, position_ids, cache=cache)
        if cache is not None:
            h, new_kv = h
        fused_arn = (None if self.is_moe or cache is not None
                     else emit.active("fuse_add_rms_norm"))
        if fused_arn is not None:
            # residual add + post-attention RMSNorm in one site
            ln = self.post_attention_layernorm
            x, h, w = amp_cast("fuse_add_rms_norm", (x, h, ln.weight))
            x, normed = checked("fuse_add_rms_norm", fused_arn(x, h, w, epsilon=ln.epsilon))
        else:
            x = x + h
            normed = self.post_attention_layernorm(x)
        if self.is_moe:
            h, aux = self.mlp.forward_with_aux(normed, uniforms)
            x = x + h
            return (x, aux) if cache is None else (x, new_kv)
        x = x + self.mlp(normed)
        return x if cache is None else (x, new_kv)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        self.embed_tokens = _param([config.vocab_size, config.hidden_size], config,
                                   device, gen, config.initializer_range)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, device, gen)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, device, gen)
        cos, sin = rope_mod.rope_freqs(config.head_dim, config.max_position_embeddings,
                                       config.rope_theta, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        """Zero dense KV cache ``{"kv": [(k, v) per layer], "offset": 0}``;
        ``max_len`` rounds up to a multiple of 128 as in the JAX model."""
        cfg = self.config
        max_len = (max_len + 127) // 128 * 128
        dt = to_dtype(dtype if dtype is not None else cfg.dtype)
        shape = (batch_size, max_len, cfg.kv_heads, cfg.head_dim)
        kv = [(torch.zeros(shape, dtype=dt, device=self.device),
               torch.zeros(shape, dtype=dt, device=self.device))
              for _ in range(cfg.num_hidden_layers)]
        return {"kv": kv, "offset": 0}

    def init_paged_pools(self, num_blocks: int, block_size: int = 128, dtype=None):
        """Serving-layout pools per layer, ``[NB, Hk, bs, D]`` (block 0 is
        the trash block)."""
        cfg = self.config
        dt = to_dtype(dtype if dtype is not None else cfg.dtype)
        shape = (num_blocks, cfg.kv_heads, block_size, cfg.head_dim)

        def pools():
            return [torch.zeros(shape, dtype=dt, device=self.device)
                    for _ in range(cfg.num_hidden_layers)]

        return pools(), pools()

    def forward(self, input_ids, position_ids=None, cache=None, skip_final_norm: bool = False):
        """Final hidden states; with ``cache`` also the updated cache.
        ``skip_final_norm`` (no cache) returns the hidden states before the
        final norm, for a caller that applies ``self.norm``'s weight itself
        (the fused RMSNorm + vocab projection).  An MoE model without a
        cache returns ``(hidden, aux)``, the MoE layers' summed aux loss, as
        the JAX LlamaModel does; with a cache it drops the aux."""
        cfg = self.config
        input_ids, emb = amp_cast("embedding", (input_ids, self.embed_tokens))
        x = checked("embedding", F.embedding(input_ids.long(), emb))
        if cfg.pdtype != cfg.dtype:
            x = x.to(to_dtype(cfg.dtype))
        cos, sin = self.rope_cos, self.rope_sin
        seq = input_ids.shape[1]
        if cache is not None and "block_table" in cache:
            tbl, lengths = cache["block_table"], cache["lengths"]
            for layer, k_p, v_p in zip(self.layers, cache["k"], cache["v"]):
                x, _ = layer(x, cos, sin, cache=(k_p, v_p, tbl, lengths))
            if seq > 1:   # chunk prefill: every row is an active chunk
                new_lengths = lengths + seq
            else:         # decode: lengths == 0 marks an inactive slot
                new_lengths = lengths + (lengths > 0).to(lengths.dtype)
            return self.norm(x), {"k": cache["k"], "v": cache["v"],
                                  "block_table": tbl,
                                  "lengths": new_lengths.to(lengths.dtype)}
        if cache is not None:
            offset = int(cache["offset"])
            for layer, (k_c, v_c) in zip(self.layers, cache["kv"]):
                x, _ = layer(x, cos, sin, cache=(k_c, v_c, offset))
            return self.norm(x), {"kv": cache["kv"], "offset": offset + seq}
        rl = cfg.recompute_layers
        is_moe = cfg.moe_num_experts > 1
        aux_total = None
        tokens = input_ids.shape[0] * seq
        for i, layer in enumerate(self.layers):
            # the gshard draws come from the generator here, outside a
            # checkpoint: its recompute restores only the default generators
            u = layer.mlp.draw_uniforms(tokens) if layer.is_moe else None
            if cfg.recompute or (rl is not None and i < rl):
                out = checkpoint(layer, x, cos, sin, position_ids, None, u,
                                 use_reentrant=False)
            else:
                out = layer(x, cos, sin, position_ids, uniforms=u)
            if layer.is_moe:
                x, aux = out
                aux_total = aux if aux_total is None else aux_total + aux
            else:
                x = out
        x = x if skip_final_norm else self.norm(x)
        return (x, aux_total) if is_moe else x


class LlamaForCausalLM(nn.Module):
    """Decoder + LM head.  ``device`` defaults to ``"cuda"`` (raising
    without a card); weights are drawn from a generator seeded with
    ``seed``, which then also serves ``generate``'s sampling."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        _check_supported(config)
        device = default_device(device)
        self.config = config
        self.generator = make_generator(seed, device)
        self.llama = LlamaModel(config, device, self.generator)
        self._moe_aux = None      # the MoE aux loss of the last forward without a cache
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = _param([config.hidden_size, config.vocab_size], config,
                                  device, self.generator, config.initializer_range)

    @property
    def decoder(self) -> LlamaModel:
        """The decoder body, the one name the head, ``forward``, ``generate``
        and the serving Engine reach it by (``self.ssd`` in the SSD family)."""
        return self.llama

    @property
    def device(self) -> torch.device:
        return self.llama.device

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        return self.llama.init_cache(batch_size, max_len, dtype)

    def init_paged_pools(self, num_blocks: int, block_size: int = 128, dtype=None):
        return self.llama.init_paged_pools(num_blocks, block_size, dtype)

    def __call__(self, *args, **kwargs):
        """The user's entry: Tensors in, Tensors out; plain torch inside."""
        return call_unwrapped(super().__call__, args, kwargs)

    def head(self, hidden):
        """Vocab projection of final hidden states (``lm_head`` under AMP)."""
        if self.lm_head is None:
            hidden, w = amp_cast("lm_head", (hidden, self.decoder.embed_tokens))
            return checked("lm_head", hidden @ w.to(hidden.dtype).T)
        hidden, w = amp_cast("lm_head", (hidden, self.lm_head))
        return checked("lm_head", hidden @ w.to(hidden.dtype))

    def forward(self, input_ids, position_ids=None, cache=None):
        """Logits; with ``cache`` returns ``(logits, new_cache)``.  The SSD
        family borrows this method and keeps its stock head, as its JAX
        forward does: only a Llama decoder takes the fused head."""
        is_moe = getattr(self.config, "moe_num_experts", 1) > 1
        self._moe_aux = None
        fused_head = (None if cache is not None or is_moe
                      or not isinstance(self.decoder, LlamaModel)
                      else emit.active("fuse_rms_norm_head"))
        if fused_head is not None:
            # final RMSNorm + vocab projection in one site, on pre-norm rows
            hidden = self.decoder(input_ids, position_ids, skip_final_norm=True)
            norm = self.decoder.norm
            tied = self.lm_head is None
            hidden, wn, w = amp_cast("lm_head", (hidden, norm.weight, self.decoder.embed_tokens
                                                 if tied else self.lm_head))
            return checked("lm_head", fused_head(hidden, wn, w, epsilon=norm.epsilon,
                                                 transpose=tied))
        if is_moe and cache is None:
            # the routers' aux loss of this forward, for compute_loss
            out, self._moe_aux = self.decoder(input_ids, position_ids)
        else:
            out = self.decoder(input_ids, position_ids, cache=cache)
        if cache is not None:
            hidden, new_cache = out
            return self.head(hidden), new_cache
        return self.head(out)

    @boundary
    def compute_loss(self, logits, labels, ignore_index: int = -100):
        """Next-token cross-entropy in fp32: logits at position t against
        label t + 1, averaged over the labels that are not
        ``ignore_index``; for MoE plus ``moe_aux_loss_weight`` times the aux
        loss of the forward that gave ``logits`` (the last one without a
        cache)."""
        if isinstance(labels, np.ndarray):
            labels = torch.from_numpy(labels)
        (logits,) = amp_cast("cross_entropy", (logits,))
        lb = labels.to(logits.device)[:, 1:].long()
        nll = _ce_no_gather(logits[:, :-1, :], lb)
        mask = (lb != ignore_index).to(torch.float32)
        loss = checked("cross_entropy",
                       torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0))
        aux = getattr(self, "_moe_aux", None)
        if aux is not None:
            loss = loss + self.config.moe_aux_loss_weight * aux
        return loss

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def _sample_next(self, logits, done, do_sample, temperature, top_k, top_p,
                     eos, generator):
        if do_sample:
            lg = logits / max(temperature, 1e-6)
            if top_k and top_k > 0:
                kth = torch.sort(lg, dim=-1).values[:, -int(top_k)][:, None]
                lg = torch.where(lg < kth, NEG_INF, lg)
            if top_p < 1.0:
                srt = torch.sort(lg, dim=-1, descending=True).values
                probs = torch.softmax(srt, dim=-1)
                csum = torch.cumsum(probs, dim=-1)
                keep = (csum - probs) < top_p  # always keeps the top token
                thresh = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
                lg = torch.where(lg < thresh, NEG_INF, lg)
            tok = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        if eos is not None:
            tok = torch.where(done, torch.full_like(tok, eos), tok)
        return tok

    @boundary
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        """Autoregressive generation (greedy or temperature/top-k/top-p
        sampling): prefill with a dense cache, then single-token steps
        through the dense decode kernel (attention layers).  Returns ``[B, P + max_new_tokens]``
        int32 ids; sequences that hit ``eos_token_id`` are padded with it."""
        if isinstance(input_ids, np.ndarray):
            input_ids = torch.from_numpy(input_ids)
        ids = input_ids.to(device=self.device, dtype=torch.int32)
        gen = generator if generator is not None else self.generator
        return self._generate_loop(ids, max_new_tokens, dict(
            do_sample=do_sample, temperature=temperature, top_k=top_k, top_p=top_p,
            eos=eos_token_id, generator=gen))

    def _generate_loop(self, ids, max_new_tokens: int, sample: dict):
        """``generate``'s loop over int32 ``ids`` ``[B, P]`` on the model's
        device; ``export_generate`` traces it greedy."""
        B, P = ids.shape
        eos = sample["eos"]
        cache = self.init_cache(B, P + max_new_tokens)
        hidden, cache = self.decoder(ids, cache=cache)
        done = torch.zeros(B, dtype=torch.bool, device=ids.device)
        tok = self._sample_next(self.head(hidden[:, -1]).float(), done, **sample)
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            if eos is not None:
                done = done | (tok == eos)
            hidden, cache = self.decoder(tok[:, None], cache=cache)
            tok = self._sample_next(self.head(hidden[:, -1]).float(), done, **sample)
            toks.append(tok)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)

    def export_generate(self, path: str, batch_size: int, prompt_len: int,
                        max_new_tokens: int, eos_token_id: Optional[int] = None) -> int:
        """Export greedy decoding as a ``jit.save`` artifact (``.pt2`` +
        ``.pdiparams`` + ``.pdmodel.json``, format ``"torch.export"``; the
        JAX package writes StableHLO) that ``jit.load`` and
        ``inference.Predictor`` run: int32 ids ``[batch_size, prompt_len]``
        in, ``[batch_size, prompt_len + max_new_tokens]`` out.  The program
        is ``generate``'s loop, unrolled at these fixed shapes (a dense-cache
        prefill, then one-token steps); its kernel entries are the custom
        ops of ``kernels.export_ops``, so the loaded program launches the
        RMSNorm and dense decode kernels as ``generate`` does.  Returns the
        bytes written."""
        from ..jit import export_artifact

        sample = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                      eos=eos_token_id, generator=None)

        def greedy(model, ids):
            return model._generate_loop(ids, int(max_new_tokens), sample)

        return export_artifact(self, [((batch_size, prompt_len), "int32")], path, call=greedy,
                               meta={"generate": {"max_new_tokens": int(max_new_tokens),
                                                  "eos_token_id": eos_token_id}})
