"""``paddle_tpu_torch.incubate.nn`` (port of ``paddle_tpu.incubate.nn``)."""

from . import functional  # noqa: F401
from .layers import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd, FusedFeedForward,
    FusedLinear, FusedMultiHeadAttention, FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)

__all__ = ["FusedBiasDropoutResidualLayerNorm", "FusedDropoutAdd",
           "FusedFeedForward", "FusedLinear", "FusedMultiHeadAttention",
           "FusedMultiTransformer", "FusedTransformerEncoderLayer"]
