"""The forward kernel entries as ``torch.library`` custom ops, for
``torch.export`` (``jit.save``, ``static.save_inference_model``).

``torch.export`` traces a program with fake tensors that carry a device but
no storage: a wrapper that launches its kernel through a raw pointer cannot
run on them.  While ``framework.dispatch.tls.exporting`` is set in a thread
(by the exporter, around its trace), the wrappers called in that thread on an exported path (``rms_norm.rms_norm``,
``flash_attention.flash_attention``, and the dense decode entry
``decode_attention.masked_multihead_attention`` of an exported greedy
generate) hand their call to the custom op
instead, so the exported graph holds one ``paddle_tpu_torch::<entry>`` node
a call.  Each op's fake rule gives the output's shape and dtype; its
implementation is the wrapper itself, so a loaded program launches exactly
the kernels the eager forward launches (the plain version on CPU tensors).
The ops are registered when this module is imported, which
``paddle_tpu_torch.kernels`` does: a process that loads an exported
program imports the package first.  Forward only: an exported program is
an inference program.
"""

from __future__ import annotations

import contextlib

import torch

from ..framework.dispatch import tls

__all__ = ["export_trace", "rms_norm_op", "flash_attention_op",
           "masked_multihead_attention_op"]


@contextlib.contextmanager
def export_trace():
    """Route this thread's wrapper calls to the custom ops for the duration
    of a trace."""
    prev, tls.exporting = tls.exporting, True
    try:
        yield
    finally:
        tls.exporting = prev


@torch.library.custom_op("paddle_tpu_torch::rms_norm", mutates_args=())
def rms_norm_op(x: torch.Tensor, weight: torch.Tensor, epsilon: float) -> torch.Tensor:
    from .rms_norm import rms_norm

    with torch.no_grad():
        return rms_norm(x, weight, epsilon)


@rms_norm_op.register_fake
def _rms_norm_fake(x, weight, epsilon):
    return torch.empty_like(x)


@torch.library.custom_op("paddle_tpu_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       sm_scale: float) -> torch.Tensor:
    from .flash_attention import flash_attention_fwd

    with torch.no_grad():
        return flash_attention_fwd(q, k, v, causal, sm_scale)[0]


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, sm_scale):
    return torch.empty_like(q)


@torch.library.custom_op("paddle_tpu_torch::masked_multihead_attention", mutates_args=())
def masked_multihead_attention_op(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, lengths: torch.Tensor,
                                  sm_scale: float) -> torch.Tensor:
    from .decode_attention import masked_multihead_attention

    with torch.no_grad():
        return masked_multihead_attention(q, k_cache, v_cache, lengths, sm_scale)


@masked_multihead_attention_op.register_fake
def _masked_multihead_attention_fake(q, k_cache, v_cache, lengths, sm_scale):
    return torch.empty_like(q)
