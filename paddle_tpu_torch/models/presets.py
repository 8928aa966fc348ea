"""Training presets (the port's copy of ``bench.py``'s ``build_config``,
``DEFAULTS``, ``model_flops_per_token``, ``build_pretrain_step``,
``build_moe_step`` and ``_bench_ocr``), and the ERNIE text-classification
step.

``build_pretrain_step`` builds the exact step the JAX benchmark measures:
the preset's ``LlamaConfig``, ``AdamW(learning_rate=3e-4, weight_decay=0.1)``,
``TrainStep`` over ``compute_loss`` and ids from
``np.random.default_rng(0)``.  ``build_moe_step`` is the ``moe`` preset's
(``AdamW(learning_rate=3e-4)`` with its default decay, as bench.py has it).
``build_ocr_step`` is the ``ocr`` preset's: DBNet (``ocr_det_base`` at
640 x 640, batch 32 on a card; ``ocr_det_tiny`` at 64 x 64, batch 2 on the
CPU), ``Momentum(1e-3, 0.9)``, ``TrainStep`` over ``db_loss``.
``build_ernie_step`` trains ``ErnieForSequenceClassification`` with the
ERNIE recipe's ``Adam(learning_rate=2e-3)`` (``tests/test_ernie.py``) at
ERNIE-1.0-base widths (:func:`ernie_base_config`), batch 32 x seq 512.
Weights come from the port's own seeded generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import default_device
from ..incubate.moe import effective_top_k
from ..jit import TrainStep
from ..optimizer import Adam, AdamW, Momentum
from .ernie import ErnieConfig, ErnieForSequenceClassification
from .llama import LlamaConfig, LlamaForCausalLM, llama_tiny_config
from .ocr import db_loss, ocr_det_base, ocr_det_tiny

__all__ = ["DEFAULTS", "MOE_DEFAULTS", "OCR_DEFAULTS", "build_config",
           "moe_config", "model_flops_per_token", "build_pretrain_step", "build_moe_step",
           "build_ocr_step", "ernie_base_config", "ernie_flops_per_example", "build_ernie_step"]

DEFAULTS = {  # preset -> (batch, seq, steps)
    "tiny": (4, 128, 5),
    "small": (8, 2048, 10),
    "base": (3, 2048, 10),
    "longctx": (1, 16384, 5),
}
MOE_DEFAULTS = {"cuda": (4, 2048, 10), "cpu": (2, 128, 3)}   # device type -> (batch, seq, steps)
OCR_DEFAULTS = {"cuda": (32, 640), "cpu": (2, 64)}   # device type -> (batch, image size)
ERNIE_BATCH, ERNIE_SEQ, ERNIE_CLASSES = 32, 512, 2


def model_flops_per_token(cfg: LlamaConfig, seq_len: int) -> float:
    """Training FLOPs per token: 6 * matmul-params (fwd 2P + bwd 4P) plus
    attention score/value matmuls (2*2*S*dh*h FLOPs fwd, halved by causal
    masking, tripled for fwd+bwd).

    MoE configs count the routed work: the router, and the three products
    of ``top_k`` experts a token (one for the switch gate, two for gshard).
    Dispatch, combine and the empty capacity slots the batched expert
    products also run are not counted.  bench.py's ``moe`` figure comes from
    XLA's cost analysis, which also counts the one-hot dispatch and combine
    einsums, so the two numbers are not comparable."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    hk = cfg.kv_heads
    hidden, inter = cfg.hidden_size, cfg.intermediate_size
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    per_layer = hidden * (h + 2 * hk) * d          # qkv
    per_layer += h * d * hidden                    # o
    if cfg.moe_num_experts > 1:
        k = effective_top_k(cfg.moe_gate, cfg.moe_top_k)
        per_layer += hidden * cfg.moe_num_experts      # router
        per_layer += k * (hidden * 2 * inter + inter * hidden)
    else:
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
                        accum: int = 1, grad_dtype=None, seed: int = 0, layers=None):
    """The pretrain ``TrainStep`` of a tiny/small/base/longctx preset.

    ``device`` defaults to CUDA (raising without a card).  Compute is bf16
    on a card and fp32 on the CPU, as ``bench.py`` picks it; ``seed`` seeds
    the weights (the batch is always ``bench.py``'s); ``layers`` cuts the
    decoder's depth (widths unchanged).  Returns
    ``(step_fn, ids, model, cfg, (batch, seq, steps))``; ``ids`` lie on the
    device, shaped ``[accum, batch, seq]`` when ``accum > 1``."""
    if preset not in DEFAULTS:
        raise ValueError(f"not a pretrain preset: {preset!r} (choose from {sorted(DEFAULTS)})")
    dev = default_device(device)
    cfg = build_config(preset, "bfloat16" if dev.type == "cuda" else "float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=int(layers))
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


def moe_config(on_card: bool) -> LlamaConfig:
    """The ``moe`` preset (``bench.py``'s ``build_moe_step``; BASELINE
    configs[4]'s shape): 12 layers, hidden 1024, 8 experts of 1408, top-2
    over the gshard gate, in bf16, on a card; the tiny Llama with 4 experts
    in fp32 on the CPU."""
    if on_card:
        return LlamaConfig(vocab_size=32000, hidden_size=1024, intermediate_size=1408,
                           num_hidden_layers=12, num_attention_heads=16,
                           num_key_value_heads=8, max_position_embeddings=2048,
                           dtype="bfloat16", moe_num_experts=8, moe_top_k=2)
    return llama_tiny_config(dtype="float32", moe_num_experts=4, moe_top_k=2)


def build_moe_step(device=None, batch=None, seq=None, steps=None, accum: int = 1,
                   seed: int = 0):
    """The ``moe`` preset's ``TrainStep``, line for line after ``bench.py``'s
    ``build_moe_step``: bf16 at full width on a card, the tiny MoE Llama in
    fp32 on the CPU; ``AdamW(learning_rate=3e-4)``; ids from
    ``np.random.default_rng(0)``.  ``seed`` seeds the weights and the gshard
    draws.  Returns ``(step_fn, ids, model, cfg, (batch, seq, steps))``."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    cfg = moe_config(on_card)
    d_batch, d_seq, d_steps = MOE_DEFAULTS["cuda" if on_card else "cpu"]
    batch, seq, steps = batch or d_batch, seq or d_seq, steps or d_steps
    model = LlamaForCausalLM(cfg, device=dev, seed=seed)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters())

    def loss_fn(m, ids):
        return m.compute_loss(m(ids), ids)

    step_fn = TrainStep(model, loss_fn, opt, accumulate_steps=accum)
    rng = np.random.default_rng(0)
    shape = (accum, batch, seq) if accum > 1 else (batch, seq)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32))
    return step_fn, ids.to(dev), model, cfg, (batch, seq, steps)


def build_ocr_step(device=None, seed: int = 0):
    """The ``ocr`` preset's ``TrainStep``, line for line after ``bench.py``'s
    ``_bench_ocr``: ``ocr_det_base`` on a card, ``ocr_det_tiny`` on the CPU;
    ``Momentum(learning_rate=1e-3, momentum=0.9)``; images N(0, 1) and a
    ground-truth map with 20% ones from ``np.random.default_rng(0)``.
    ``seed`` seeds the weights.  Returns ``(step_fn, (img, gt), model,
    (batch, size))``, the batch on the device."""
    dev = default_device(device)
    on_card = dev.type == "cuda"
    batch, size = OCR_DEFAULTS["cuda" if on_card else "cpu"]
    model = (ocr_det_base if on_card else ocr_det_tiny)(device=dev, seed=seed)
    opt = Momentum(learning_rate=1e-3, momentum=0.9, parameters=model.parameters())

    def loss_fn(m, img, gt):
        return db_loss(m(img), gt)

    step_fn = TrainStep(model, loss_fn, opt)
    rng = np.random.default_rng(0)
    img = rng.normal(size=(batch, 3, size, size)).astype(np.float32)
    gt = (rng.random(size=(batch, 1, size, size)) < 0.2).astype(np.float32)
    batch_t = tuple(torch.from_numpy(a).to(dev) for a in (img, gt))
    return step_fn, batch_t, model, (batch, size)


def ernie_base_config(**overrides) -> ErnieConfig:
    """ERNIE-1.0-base widths (the published ``ernie-1.0-base-zh`` config):
    hidden 768, 12 layers of 12 heads (head dim 64), intermediate 3072,
    vocab 18000, 513 positions, 2 segment types, dropout 0.1."""
    cfg = dict(vocab_size=18000, hidden_size=768, num_hidden_layers=12,
               num_attention_heads=12, intermediate_size=3072, max_position_embeddings=513,
               type_vocab_size=2, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    cfg.update(overrides)
    return ErnieConfig(**cfg)


def ernie_flops_per_example(cfg: ErnieConfig, seq_len: int) -> float:
    """Training FLOPs of one sequence: 6 x the matmul parameters a token
    touches (q, k, v, out, the two FFN products; the pooler and classifier
    once a sequence) plus attention's two S x S products a layer (4 S d h a
    token forward, non-causal, tripled for the backward)."""
    hd, inter, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    per_token = 6.0 * L * (4 * hd * hd + 2 * hd * inter) + 3.0 * L * 4 * seq_len * hd
    return per_token * seq_len + 6.0 * (hd * hd + hd * ERNIE_CLASSES)


def build_ernie_step(device=None, seed: int = 0):
    """The ERNIE text-classification ``TrainStep``: :func:`ernie_base_config`,
    two classes, ``Adam(learning_rate=2e-3)``, ``ERNIE_BATCH`` x
    ``ERNIE_SEQ`` token ids and labels from ``np.random.default_rng(seed)``
    (which also seeds the weights), the label's marker token at position 1
    as in the recipe's synthetic task; no padding mask.  Returns
    ``(step_fn, (ids, labels), model, cfg)``, the batch on the device."""
    dev = default_device(device)
    cfg = ernie_base_config()
    batch, seq, num_classes = ERNIE_BATCH, ERNIE_SEQ, ERNIE_CLASSES
    model = ErnieForSequenceClassification(cfg, num_classes=num_classes, device=dev, seed=seed)
    opt = Adam(learning_rate=2e-3, parameters=model.parameters())

    def loss_fn(m, ids, labels):
        return m.compute_loss(m(ids), labels)

    step_fn = TrainStep(model, loss_fn, opt)
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, cfg.vocab_size, size=(batch, seq)).astype(np.int64)
    labels = rng.integers(0, num_classes, size=(batch,)).astype(np.int64)
    ids[:, 1] = labels + 1           # the class's marker token, as the recipe's task
    batch_t = tuple(torch.from_numpy(a).to(dev) for a in (ids, labels))
    return step_fn, batch_t, model, cfg
