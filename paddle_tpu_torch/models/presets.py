"""Pretraining presets (the port's copy of ``bench.py``'s ``build_config``,
``DEFAULTS``, ``model_flops_per_token`` and ``build_pretrain_step``).

``build_pretrain_step`` builds the exact step the JAX benchmark measures:
the preset's ``LlamaConfig``, ``AdamW(learning_rate=3e-4, weight_decay=0.1)``,
``TrainStep`` over ``compute_loss`` and ids from
``np.random.default_rng(0)``.  Weights come from the port's own seeded
generator.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import default_device
from ..jit import TrainStep
from ..optimizer import AdamW
from .llama import LlamaConfig, LlamaForCausalLM, llama_tiny_config

__all__ = ["DEFAULTS", "build_config", "model_flops_per_token", "build_pretrain_step"]

DEFAULTS = {  # preset -> (batch, seq, steps)
    "tiny": (4, 128, 5),
    "small": (8, 2048, 10),
    "base": (3, 2048, 10),
    "longctx": (1, 16384, 5),
}


def model_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token: 6 * matmul-params (fwd 2P + bwd 4P) plus
    attention score/value matmuls (2*2*S*dh*h FLOPs fwd, halved by causal
    masking, tripled for fwd+bwd)."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    hk = cfg.kv_heads
    hidden, inter = cfg.hidden_size, cfg.intermediate_size
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    per_layer = hidden * (h + 2 * hk) * d          # qkv
    per_layer += h * d * hidden                    # o
    per_layer += hidden * 2 * inter + inter * hidden  # gate_up + down
    p_matmul = L * per_layer + hidden * V          # + lm_head
    attn = L * (4 * seq_len * d * h) * 0.5         # causal
    return 6.0 * p_matmul + 3.0 * attn


def build_config(preset: str, dtype: str) -> LlamaConfig:
    if preset == "tiny":
        return llama_tiny_config(dtype=dtype)
    if preset == "small":
        return LlamaConfig(vocab_size=32000, hidden_size=768, intermediate_size=2048,
                           num_hidden_layers=12, num_attention_heads=12,
                           num_key_value_heads=4, max_position_embeddings=2048,
                           dtype=dtype, recompute=True)
    if preset == "base":
        # fp32-stored params with bf16 compute: master weights without a
        # separate master copy
        return LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                           num_hidden_layers=12, num_attention_heads=16,
                           num_key_value_heads=8, max_position_embeddings=2048,
                           dtype=dtype, recompute=False,
                           param_dtype="float32" if dtype != "float32" else None)
    if preset == "longctx":
        # the same model at seq 16384, one sequence, layers recomputed
        return LlamaConfig(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                           num_hidden_layers=12, num_attention_heads=16,
                           num_key_value_heads=8, max_position_embeddings=16384,
                           dtype=dtype, recompute=True,
                           param_dtype="float32" if dtype != "float32" else None)
    raise ValueError(preset)


def build_pretrain_step(preset: str, device=None, batch=None, seq=None, steps=None,
                        accum: int = 1, grad_dtype=None, seed: int = 0):
    """The pretrain ``TrainStep`` of a tiny/small/base/longctx preset.

    ``device`` defaults to CUDA (raising without a card).  Compute is bf16
    on a card and fp32 on the CPU, as ``bench.py`` picks it; ``seed`` seeds
    the weights (the batch is always ``bench.py``'s).  Returns
    ``(step_fn, ids, model, cfg, (batch, seq, steps))``; ``ids`` lie on the
    device, shaped ``[accum, batch, seq]`` when ``accum > 1``."""
    if preset not in DEFAULTS:
        raise ValueError(f"not a pretrain preset: {preset!r} (choose from {sorted(DEFAULTS)})")
    dev = default_device(device)
    cfg = build_config(preset, "bfloat16" if dev.type == "cuda" else "float32")
    d_batch, d_seq, d_steps = DEFAULTS[preset]
    batch = batch or d_batch
    seq = min(seq or d_seq, cfg.max_position_embeddings)
    steps = steps or d_steps
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1, parameters=model.parameters())

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    step_fn = TrainStep(model, loss_fn, opt, accumulate_steps=accum, grad_dtype=grad_dtype)
    rng = np.random.default_rng(0)
    shape = (accum, batch, seq) if accum > 1 else (batch, seq)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32))
    return step_fn, ids.to(dev), model, cfg, (batch, seq, steps)
