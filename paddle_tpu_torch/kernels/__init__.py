"""Kernels of the port: each wrapper launches a hand-written CUDA kernel
(``csrc/``) on CUDA tensors and runs its plain PyTorch version on CPU
tensors.  Nothing here builds or loads CUDA code at import time.

RMSNorm and decode attention serve; RMSNorm's backward (the add + RMSNorm
backward kernel, norm-only), flash attention forward and backward
and the fused AdamW train; the SSD chunked scan's forward and backward
train the SSD family; the fusion sites of :mod:`.emit` (a tiled GEMM with the
sites' prologues and epilogues, and the residual add + RMSNorm) train when
a table of sites is activated.  :mod:`.injected` holds the kernel gate's
seeded defects, launched only by the gate.  :mod:`.registry` is the
admission-gated registry every wrapper checks in with first.

Every wrapper carries a plain integer ``launches`` attribute, raised by one
exactly where its kernel is launched; :func:`launch_counts` and
:func:`reset_launch_counts` read and clear them all.
"""

from __future__ import annotations

from typing import Dict

from . import (adamw, add_rms_norm, decode_attention, emit, flash_attention, fused_gemm,
               injected, registry, rms_norm, rope, ssd_scan)

__all__ = ["adamw", "add_rms_norm", "decode_attention", "emit", "flash_attention",
           "fused_gemm", "injected", "registry", "rms_norm", "rope", "ssd_scan",
           "launch_counts", "reset_launch_counts", "GATE_WRAPPERS", "WRAPPERS"]

# kernel name -> wrapper with a ``launches`` counter
WRAPPERS = {
    "rms_norm": rms_norm.rms_norm,
    "rms_norm_bwd": rms_norm.rms_norm_backward,                   # one per backward
    "decode_attention_dense": decode_attention.masked_multihead_attention,
    "decode_attention_paged": decode_attention.paged_decode_attention,
    "flash_attention_fwd": flash_attention.flash_attention_fwd,
    "flash_attention_bwd": flash_attention.flash_attention_bwd,   # one per backward: both passes
    "adamw": adamw.adamw_update,                                  # one per leaf
    "ssd_scan": ssd_scan.ssd_scan,                                # one per forward
    "ssd_scan_bwd": ssd_scan.ssd_scan_bwd,                        # one per backward
    # the fusion sites: one per site forward or backward, whatever it launches
    "fuse_swiglu_mlp": emit.fuse_swiglu_mlp_fwd,
    "fuse_swiglu_mlp_bwd": emit.fuse_swiglu_mlp_bwd,
    "fuse_add_rms_norm": emit.fuse_add_rms_norm_fwd,
    "fuse_add_rms_norm_bwd": emit.fuse_add_rms_norm_bwd,
    "fuse_rms_norm_head": emit.fuse_rms_norm_head_fwd,
    "fuse_rms_norm_head_bwd": emit.fuse_rms_norm_head_bwd,
}
# the kernel gate's seeded defects: launched by the gate only, so kept out of
# the system's paths' counts
GATE_WRAPPERS = {
    "injected_write_race": injected.write_race,
    "injected_parallel_carry": injected.parallel_carry,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in (*WRAPPERS.values(), *GATE_WRAPPERS.values()):
        fn.launches = 0
