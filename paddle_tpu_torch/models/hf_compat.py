"""HuggingFace-transformers checkpoint interop, Llama and ERNIE/BERT (port
of ``paddle_tpu/models/hf_compat.py``).

A ``transformers`` checkpoint -- a model, or anything with
``.state_dict()``, or a plain state dict of tensors or numpy arrays (e.g.
from safetensors) -- converts into the port's models, and back:

- torch ``nn.Linear`` stores ``[out, in]``; the port's matmul weights are
  ``[in, out]``: transposed;
- Llama's ``q_proj`` / ``k_proj`` / ``v_proj`` become one ``qkv_proj``
  ``[hidden, (h + 2 hk) d]`` and ``gate_proj`` / ``up_proj`` one
  ``gate_up_proj`` ``[hidden, 2 inter]``; ``lm_head.weight`` is absent
  when the embeddings are tied;
- ERNIE/BERT's ``attention.self.query`` etc. become the stock
  ``TransformerEncoderLayer``'s ``self_attn.q_proj`` etc.; every LayerNorm
  takes the checkpoint's epsilon (1e-12 for BERT and ERNIE), not the
  Paddle default 1e-5.

The conversion is done on the host in fp32 numpy, one tensor at a time,
then copied into the model on its device.  ``transformers`` itself is
never imported: configs are read by attribute name.  ``device`` defaults
to CUDA (raising without a card) and ``seed`` seeds the model built before
the weights land, as for every model of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .convert import load_paddle_tpu_params
from .ernie import ErnieConfig, ErnieForSequenceClassification, ErnieModel
from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["llama_config_from_transformers", "llama_from_transformers",
           "llama_to_transformers_state_dict", "ernie_config_from_transformers",
           "ernie_from_transformers", "ernie_to_transformers_state_dict"]


def llama_config_from_transformers(hf_config, **overrides) -> LlamaConfig:
    """A :class:`LlamaConfig` from a ``transformers`` LlamaConfig (anything
    with its attribute names)."""
    kw = dict(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        num_key_value_heads=getattr(hf_config, "num_key_value_heads", None),
        max_position_embeddings=hf_config.max_position_embeddings,
        rms_norm_eps=getattr(hf_config, "rms_norm_eps", 1e-6),
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
    )
    kw.update(overrides)
    return LlamaConfig(**kw)


def _hf_state_dict(src) -> dict:
    """A model, a torch state dict or a plain mapping as ``{name: fp32
    numpy array}`` on the host (a copy: the converter pops from it)."""
    if callable(getattr(src, "state_dict", None)):
        src = src.state_dict()
    return {k: (v.detach().to("cpu", torch.float32).numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, dtype=np.float32))
            for k, v in src.items()}


def _fetch(sd: Mapping[str, np.ndarray], name: str, prefixes=("", "model."),
           pop: bool = False) -> np.ndarray:
    """``name`` under any of the task-model prefixes transformers uses
    (``model.`` on ``LlamaForCausalLM``, ``ernie.`` / ``bert.`` on
    classification heads, none on bare models).  ``pop`` releases each
    tensor as it is consumed, so host memory stays near one fp32 copy."""
    for p in prefixes:
        if p + name in sd:
            return sd.pop(p + name) if pop else sd[p + name]
    raise KeyError(f"HF checkpoint is missing {name!r} (have e.g. {sorted(sd)[:4]})")


def _check_config_exclusive(config, config_overrides) -> None:
    if config is not None and config_overrides:
        raise ValueError("config= and config overrides are mutually exclusive -- bake the "
                         f"overrides into the config you pass (got {sorted(config_overrides)})")


def _config_of(src, config, make, overrides):
    _check_config_exclusive(config, overrides)
    if config is not None:
        return config
    if not hasattr(src, "config"):
        raise ValueError("pass config= when converting from a bare state dict")
    return make(src.config, **overrides)


def llama_from_transformers(src, config: Optional[LlamaConfig] = None, *, device=None,
                            seed: int = 0, **config_overrides) -> LlamaForCausalLM:
    """A :class:`LlamaForCausalLM` on ``device`` from a ``transformers``
    Llama checkpoint; ``config`` is derived from ``src.config`` when not
    given (``config_overrides`` tweak the derived one)."""
    config = _config_of(src, config, llama_config_from_transformers, config_overrides)
    sd = _hf_state_dict(src)

    def k(name):
        return _fetch(sd, name, pop=True)

    h, d, hk = config.num_attention_heads, config.head_dim, config.kv_heads
    ours = {"llama.embed_tokens": k("embed_tokens.weight")}
    for i in range(config.num_hidden_layers):
        p, o = f"layers.{i}.", f"llama.layers.{i}."
        q = k(p + "self_attn.q_proj.weight").T
        kk = k(p + "self_attn.k_proj.weight").T
        v = k(p + "self_attn.v_proj.weight").T
        if q.shape[1] != h * d or kk.shape[1] != hk * d:
            raise ValueError(f"layer {i}: q/k shapes {q.shape}/{kk.shape} do not match config "
                             f"heads {h}x{d} / kv {hk}x{d}")
        ours[o + "self_attn.qkv_proj"] = np.concatenate([q, kk, v], axis=1)
        ours[o + "self_attn.o_proj"] = k(p + "self_attn.o_proj.weight").T
        ours[o + "mlp.gate_up_proj"] = np.concatenate(
            [k(p + "mlp.gate_proj.weight").T, k(p + "mlp.up_proj.weight").T], axis=1)
        ours[o + "mlp.down_proj"] = k(p + "mlp.down_proj.weight").T
        ours[o + "input_layernorm.weight"] = k(p + "input_layernorm.weight")
        ours[o + "post_attention_layernorm.weight"] = k(p + "post_attention_layernorm.weight")
    ours["llama.norm.weight"] = k("norm.weight")
    if not config.tie_word_embeddings:
        # a tied checkpoint under an untied config: the head reads the table
        ours["lm_head"] = (sd.pop("lm_head.weight") if "lm_head.weight" in sd
                           else ours["llama.embed_tokens"]).T
    model = LlamaForCausalLM(config, device=device, seed=seed)
    load_paddle_tpu_params(model, ours)
    return model


def _host(model) -> dict:
    return {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}


def llama_to_transformers_state_dict(model: LlamaForCausalLM) -> dict:
    """The model as a ``transformers`` Llama state dict: fp32 CPU tensors in
    torch's ``[out, in]`` linear layout, ``model.``-prefixed names (load it
    with ``load_state_dict``)."""
    cfg = model.config
    h, d, hk = cfg.num_attention_heads, cfg.head_dim, cfg.kv_heads
    sd = _host(model)
    out = {"model.embed_tokens.weight": sd["llama.embed_tokens"]}
    for i in range(cfg.num_hidden_layers):
        o, p = f"llama.layers.{i}.", f"model.layers.{i}."
        q, k, v = sd[o + "self_attn.qkv_proj"].split([h * d, hk * d, hk * d], dim=1)
        gate, up = sd[o + "mlp.gate_up_proj"].split(cfg.intermediate_size, dim=1)
        for name, w in (("self_attn.q_proj", q), ("self_attn.k_proj", k),
                        ("self_attn.v_proj", v), ("self_attn.o_proj", sd[o + "self_attn.o_proj"]),
                        ("mlp.gate_proj", gate), ("mlp.up_proj", up),
                        ("mlp.down_proj", sd[o + "mlp.down_proj"])):
            out[p + name + ".weight"] = w.T.contiguous()
        for name in ("input_layernorm.weight", "post_attention_layernorm.weight"):
            out[p + name] = sd[o + name]
    out["model.norm.weight"] = sd["llama.norm.weight"]
    if "lm_head" in sd:
        out["lm_head.weight"] = sd["lm_head"].T.contiguous()
    return out


# ---------------------------------------------------------------------------
# ERNIE / BERT (post-LN encoder family)
# ---------------------------------------------------------------------------

_ENC_PREFIXES = ("", "ernie.", "bert.", "model.")
# (transformers' name in encoder.layer.{i}, the stock encoder layer's)
_ENC_LINEARS = (("attention.self.query", "self_attn.q_proj"),
                ("attention.self.key", "self_attn.k_proj"),
                ("attention.self.value", "self_attn.v_proj"),
                ("attention.output.dense", "self_attn.out_proj"),
                ("intermediate.dense", "linear1"),
                ("output.dense", "linear2"))
_ENC_NORMS = (("attention.output.LayerNorm", "norm1"), ("output.LayerNorm", "norm2"))
_EMBEDDINGS = (("word_embeddings.weight", "word_embeddings.weight"),
               ("position_embeddings.weight", "position_embeddings.weight"),
               ("token_type_embeddings.weight", "token_type_embeddings.weight"),
               ("LayerNorm.weight", "layer_norm.weight"),
               ("LayerNorm.bias", "layer_norm.bias"))


def ernie_config_from_transformers(hf_config, **overrides) -> ErnieConfig:
    """An :class:`ErnieConfig` from a transformers Ernie/Bert config
    (anything with its attribute names).  A checkpoint the encoder cannot
    compute (not exact GELU, not learned absolute positions) raises."""
    act = getattr(hf_config, "hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(f"checkpoint uses hidden_act={act!r} but the encoder hardcodes exact "
                         "gelu -- converting it would compute silently wrong hidden states")
    pet = getattr(hf_config, "position_embedding_type", "absolute")
    if pet != "absolute":
        raise ValueError(f"checkpoint uses position_embedding_type={pet!r} but the encoder "
                         "implements learned absolute positions only")
    kw = dict(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_hidden_layers=hf_config.num_hidden_layers,
        num_attention_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=getattr(hf_config, "type_vocab_size", 2),
        hidden_dropout_prob=getattr(hf_config, "hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=getattr(hf_config, "attention_probs_dropout_prob", 0.1),
    )
    kw.update(overrides)
    return ErnieConfig(**kw)


def ernie_from_transformers(src, config: Optional[ErnieConfig] = None,
                            layer_norm_eps: Optional[float] = None, *, device=None,
                            seed: int = 0, **config_overrides):
    """An :class:`ErnieModel` (bare checkpoint) or
    :class:`ErnieForSequenceClassification` (one with a single-Linear
    ``classifier`` head) on ``device`` from a transformers Ernie/Bert
    checkpoint.  ``layer_norm_eps`` defaults to ``src.config``'s, else 1e-12
    (a state dict carries no config).  A checkpoint with task-type
    embeddings (``use_task_id=True``) or a multi-layer head raises."""
    config = _config_of(src, config, ernie_config_from_transformers, config_overrides)
    if layer_norm_eps is None:
        layer_norm_eps = getattr(getattr(src, "config", None), "layer_norm_eps", 1e-12)
    sd = _hf_state_dict(src)
    if any("task_type_embeddings" in k for k in sd):
        raise ValueError("checkpoint was trained with use_task_id=True (task-type embeddings "
                         "present); re-export it with use_task_id=False or strip the table "
                         "if the task id is constant")

    def k(name):
        return _fetch(sd, name, _ENC_PREFIXES)

    ours = {f"ernie.embeddings.{mine}": k(f"embeddings.{theirs}")
            for theirs, mine in _EMBEDDINGS}
    for i in range(config.num_hidden_layers):
        p, o = f"encoder.layer.{i}.", f"ernie.encoder.layers.{i}."
        for theirs, mine in _ENC_LINEARS:
            ours[o + mine + ".weight"] = k(p + theirs + ".weight").T
            ours[o + mine + ".bias"] = k(p + theirs + ".bias")
        for theirs, mine in _ENC_NORMS:
            ours[o + mine + ".weight"] = k(p + theirs + ".weight")
            ours[o + mine + ".bias"] = k(p + theirs + ".bias")
    ours["ernie.pooler.weight"] = k("pooler.dense.weight").T
    ours["ernie.pooler.bias"] = k("pooler.dense.bias")

    cls_keys = sorted(n for n in sd if n.startswith("classifier."))
    if cls_keys:
        if "classifier.weight" not in sd:
            raise ValueError(f"unsupported classifier head layout {cls_keys}: only a "
                             "single-Linear head (classifier.weight/bias) converts; "
                             "RoBERTa-style multi-layer heads need a custom head")
        ours["classifier.weight"] = sd["classifier.weight"].T
        ours["classifier.bias"] = sd["classifier.bias"]
        model = ErnieForSequenceClassification(
            config, num_classes=sd["classifier.weight"].shape[0], device=device, seed=seed)
    else:
        model = ErnieModel(config, device=device, seed=seed)
        ours = {n[len("ernie."):]: v for n, v in ours.items()}
    load_paddle_tpu_params(model, ours)
    from ..nn import LayerNorm

    for layer in model.modules():
        if isinstance(layer, LayerNorm):
            layer.epsilon = layer_norm_eps
    return model


def ernie_to_transformers_state_dict(model) -> dict:
    """The inverse of :func:`ernie_from_transformers`: an ``ErnieModel`` or
    ``ErnieForSequenceClassification`` as a transformers Ernie/Bert state
    dict of fp32 CPU tensors (bare names; a classifier's under
    ``ernie.``)."""
    sd = _host(model)
    classifier = "classifier.weight" in sd
    pre = "ernie." if classifier else ""
    out = {f"{pre}embeddings.{theirs}": sd[f"{pre}embeddings.{mine}"]
           for theirs, mine in _EMBEDDINGS}
    n_layers = len(model.ernie.encoder.layers if classifier else model.encoder.layers)
    for i in range(n_layers):
        p, o = f"{pre}encoder.layer.{i}.", f"{pre}encoder.layers.{i}."
        for theirs, mine in _ENC_LINEARS:
            out[p + theirs + ".weight"] = sd[o + mine + ".weight"].T.contiguous()
            out[p + theirs + ".bias"] = sd[o + mine + ".bias"]
        for theirs, mine in _ENC_NORMS:
            out[p + theirs + ".weight"] = sd[o + mine + ".weight"]
            out[p + theirs + ".bias"] = sd[o + mine + ".bias"]
    out[f"{pre}pooler.dense.weight"] = sd[f"{pre}pooler.weight"].T.contiguous()
    out[f"{pre}pooler.dense.bias"] = sd[f"{pre}pooler.bias"]
    if classifier:
        out["classifier.weight"] = sd["classifier.weight"].T.contiguous()
        out["classifier.bias"] = sd["classifier.bias"]
    return out
