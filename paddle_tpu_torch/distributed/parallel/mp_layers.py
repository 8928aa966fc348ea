"""The cross-entropy helper of ``paddle_tpu/distributed/parallel/mp_layers.py``,
kept where the JAX package keeps it for the distributed slice that will
shard the vocabulary."""

from __future__ import annotations

import torch

__all__ = ["_ce_no_gather"]


def _ce_no_gather(lg, lb):
    """Per-token cross-entropy ``lse - target`` in fp32 over logits ``lg``
    ``[..., V]`` and integer labels ``lb`` ``[...]``; the row max is taken
    without gradient, as in the JAX helper.

    The JAX helper picks the target logit by a one-hot contraction (so
    vocab-sharded logits are never gathered); on one device a gather gives
    the same value without the ``[..., V]`` one-hot.  Out-of-range labels
    (an ``ignore_index``) pick 0, as an all-zero one-hot row does, so they
    contribute ``lse``; callers mask ignored rows themselves."""
    lg = lg.to(torch.float32)
    V = lg.shape[-1]
    m = torch.amax(lg, dim=-1).detach()
    lse = m + torch.log(torch.sum(torch.exp(lg - m[..., None]), dim=-1))
    lb = lb.long()
    valid = (lb >= 0) & (lb < V)
    target = torch.gather(lg, -1, torch.where(valid, lb, 0)[..., None])[..., 0]
    return lse - torch.where(valid, target, 0.0)
