"""ERNIE-style encoder for text classification (port of
``paddle_tpu/models/ernie.py``; BASELINE configs[0]).

A BERT-family bidirectional encoder built from the port's stock layers:
token + position + segment embeddings and LayerNorm, a post-LN
``nn.TransformerEncoder`` (exact-erf GELU), a tanh pooler over [CLS] and a
linear classifier.  The same parameter names as the JAX model, so
``models.convert`` carries weights across.  As there:

- without ``token_type_ids``, row 0 of the segment table is added (the
  default segment, not "no segment");
- an ``attention_mask`` ([B, S], 1 keeps) becomes an additive -1e9 mask on
  ``[B, 1, 1, S]``, which sends attention through the plain path; without
  one, attention runs the flash kernels when the head dim is one they take
  (ERNIE-1.0-base's 64; ERNIE-tiny's 26 is not);
- every encoder layer starts from the same weights (``TransformerEncoder``
  deep-copies its layer), and no dropout falls on attention probabilities.

``device`` defaults to CUDA (raising without a card); weights and dropout
masks come from one generator seeded with ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import default_device, make_generator
from ..framework.tensor import boundary
from .. import nn
from ..nn import functional as F

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification", "ernie_tiny_config"]


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 312          # ERNIE-tiny width
    num_hidden_layers: int = 4
    num_attention_heads: int = 12
    intermediate_size: int = 1248
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02


def ernie_tiny_config(**overrides) -> ErnieConfig:
    """ERNIE-tiny hyperparameters are the dataclass defaults (312/4/12/1248)."""
    return ErnieConfig(**overrides)


def _generator(device, seed, generator) -> torch.Generator:
    return generator if generator is not None else make_generator(seed, default_device(device))


class ErnieEmbeddings(nn.Layer):
    def __init__(self, cfg: ErnieConfig, generator: torch.Generator):
        super().__init__(generator=generator)
        kw = dict(generator=generator)
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                                **kw)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size, **kw)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, **kw)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob, **kw)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            x = x + self.token_type_embeddings.weight[0]
        else:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class ErnieModel(nn.Layer):
    """Embeddings + encoder + pooler; returns ``(sequence_output, pooled)``."""

    def __init__(self, cfg: ErnieConfig, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        gen = _generator(device, seed, generator)
        super().__init__(generator=gen)
        self.config = cfg
        self.embeddings = ErnieEmbeddings(cfg, gen)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob, normalize_before=False,
            generator=gen)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size, generator=gen)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            m = torch.as_tensor(attention_mask, device=x.device)
            mask = (1.0 - m[:, None, None, :].to(torch.float32)) * -1e9
        x = self.encoder(x, src_mask=mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class ErnieForSequenceClassification(nn.Layer):
    """Pooled [CLS] -> dropout -> linear classifier (the text-cls recipe)."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2, device=None, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        gen = _generator(device, seed, generator)
        super().__init__(generator=gen)
        self.ernie = ErnieModel(cfg, generator=gen)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob, generator=gen)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes, generator=gen)
        self.num_classes = num_classes

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))

    @boundary
    def compute_loss(self, logits, labels):
        return F.cross_entropy(logits, labels)
