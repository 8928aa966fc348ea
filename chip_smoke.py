#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version, check the card against the CPU,
pretrain the `base` preset (stock, and with the fusion sites substituted)
and the SSD family at `ssd_8b` widths for a few steps through TrainStep,
and serve Llama-3-8B-shaped and SSD-8B requests through the port's Engine.

    python3 chip_smoke.py                  # every phase, full depth
    python3 chip_smoke.py --layers 8       # cut Llama serving depth (never width)
    python3 chip_smoke.py --phases card,build,kernels,train
    python3 chip_smoke.py --phases card,build,kernels,longctx_train
    python3 chip_smoke.py --phases card,build,kernels,kernel_gate,parity,fuse_train
    python3 chip_smoke.py --phases card,build,kernels,parity,ssd_train,ssd_serve
    python3 chip_smoke.py --phases card,build,kernels,kernel_gate

Phases:
  1 card     name and power limit (nvidia-smi), torch device name
  2 build    nvcc of kernels/csrc/*.cu for sm_90a, all in parallel
  3 kernels  each kernel against its plain version at its path's shapes
             (RMSNorm at a decode step, a serving prefill and a `base`
             step; decode attention dense and paged at the kernel table's
             lengths and at the `serve` phase's own, NaN in the trash block
             and stale tails, with each of its two launches' device time;
             flash attention forward and backward at `base` and at
             `longctx`, AdamW on base's largest leaf and on all 75, the
             SSD scan at `ssd_8b`, SSDConfig()'s default, bench.py's
             on-chip and tiny widths): max error, kernel / plain / library
             time, bound; flash also against sdpa's backward alone, with
             each kernel's registers and spill bytes, its gradients tile by
             tile, and planted faults in them must be rejected; the SSD
             scan's forward and backward kernels also by norm per
             recurrence (the backward in each of dx, db, dc, dla, against
             its plain closed form, whose own fp32 error against fp64 is
             logged), with zero rows bitwise no-ops (zero gradients in the
             backward), under a log-decay near -20 a token, and against
             three planted faults each (the backward's: the state gradient
             not carried, dla without its chunk-end terms, dM's mask off by
             one); each fusion site's forward and backward at
             `base` (bf16 rows, fp32 weights; also 1000 ragged rows, the
             tied head, fp32 at 520 rows) against the plain reference and
             its autograd, elementwise and per 64-row tile (the add +
             RMSNorm backward's dx and dh with one bf16 ulp of the rounded
             norm gradient more), with the seam's stock chain timed beside
             it, and four planted faults (gate and up swapped, the last K
             tile dropped, a row's RMS skipped, a row's norm gradient
             dropped);
             the RMSNorm backward (the add + RMSNorm backward kernel):
             norm-only, as the stock RMSNorm's backward, at `base`'s,
             `longctx`'s and `ssd_train`'s rows over fp32 weights, the
             site's mode (h, d_s) at `base`, fp32 rows at the parity
             widths, untimed a ragged row, one row and the wide kernel: dx
             and dw against the plain version, dw the same bits twice,
             kernel / plain / stock-chain / library ms, bound, registers and
             spill bytes; two planted faults (a row's projection dropped
             from dx, a CTA's rows left out of dw) must be rejected;
             each bf16 GEMM launch of the sites at `base` alone (ms,
             TFLOP/s, bound, registers and spill bytes, torch.matmul on
             the same operands as its yardstick) and the two preparation
             passes (an fp32 weight rounded, the head's rows normed: bit
             for bit their plain versions);
             the gate's two seeded-defect kernels, exact on the part their
             defect leaves defined
  3b kernel_gate  the kernel gate (kernels/registry.py, analysis/
             kernel_lint.py): its CLI on the card, clean (20 entries, each
             at every dtype it has an example of, both legs, no finding,
             every kernel's shared memory as the card reports it) and under
             each KERNEL_GATE_INJECT (write-race, parallel-carry, emit-race:
             each refused with its codes, the other entries clean), four
             processes together; `parity`'s narrow Llama through the
             Engine, generate, one TrainStep step and one fused step, then
             one stock and one fused step in bf16 over fp32 params, with
             FLAGS_kernel_admission off and on: each kernel on those paths
             admitted once at the dtype it ran, tokens and losses equal,
             launch counts equal; sabotaged ssd_scan and rms_norm refused
             before their first launch
  4 parity   card (kernels) against CPU (plain versions) in fp32 on a
             narrow Llama config and on the tiny pure and hybrid SSD
             stacks: Engine and generate tokens must be equal; three
             TrainStep steps must agree in losses, step-1 gradients,
             parameters and the optimizer's m and v slots; the Llama steps
             again with every fusion site verified and activated
  5 train    the `base` preset (12 layers, batch 3, seq 2048, bf16 compute,
             fp32 params) for 5 steps on one batch with the
             launch counters zeroed just before and read just after: every
             step must launch flash forward and backward once a layer,
             RMSNorm and its backward twice a layer plus once, AdamW once a
             leaf (inside the optimizer update) and no decode kernel; losses finite and
             falling; step 1's loss within a limit of the same batch run
             with fp32 activations.  Step time, tokens/s and MFU are printed
  5a longctx_train  the `longctx` preset (the `base` model at seq 16384,
             batch 1, every decoder layer recomputed in the backward) for 3
             steps on one batch, counters zeroed just before and read just
             after: every step must launch flash forward twice a layer (the
             recompute), flash backward once a layer, RMSNorm four times a
             layer plus once and its backward twice a layer plus once, AdamW
             once a leaf (inside the update); losses
             finite and falling; step time, tokens/s and MFU are printed
  5b fuse_train  `base` in three legs, stock -> fused -> stock, each a fresh
             build_pretrain_step("base", "cuda") with the same seed, 5
             steps, counters read per step (the first stock leg is the
             `train` phase's run when that phase ran); the fused leg runs inside
             emit.activate(emit.verified_activation("cuda")) and each of its
             steps must launch every site forward and backward once a layer
             (the head's once), RMSNorm and its backward once a layer, flash
             as before and AdamW once a leaf in the update; the stock legs
             no site.
             Losses finite and falling; the fused step-1 loss within a
             limit of the stock one; the stock legs equal
  6 serve    llama3_8b_config, bf16, random weights from --seed, three
             paths each with the launch counters zeroed just before it and
             read just after it: 16 requests (two share a 256-token prefix)
             through the Engine, one chunked-prefill request through a
             second Engine, generate on two prompts.  Every decode step of
             each path must launch its decode kernel once a layer and
             RMSNorm twice a layer plus once; generate's and the Engine's
             first-token logits must agree within a bf16 limit

  7 ssd_train  ssd_8b_config cut to 8 layers, fp32 params, bf16 compute,
             batch 2 x seq 4096, 5 steps on one batch, counters zeroed just
             before and read just after: every step must launch the SSD
             scan's forward and its backward once a layer, RMSNorm and its
             backward once a layer plus once, AdamW once a leaf (inside the
             update) and no attention
             kernel; losses finite and falling; step 1's loss within a
             limit of the fp32-activation loss
  8 ssd_serve  ssd_8b_config at 32 layers, bf16, random weights from
             --seed: 16 requests through the Engine's recurrent path and
             generate on two prompts, counters per path: every decode step
             and prefill must launch RMSNorm once a layer plus once and no
             other kernel; the Engine's first-token logits within a bf16
             limit of generate's
  9 profile  (a diagnostic: it prints and checks nothing) one
             decode-dominated Engine drain at 8B widths, one `base`
             training step (stock and fused) and one `ssd_train` step under
             torch.profiler:
             device time by kernel, and the device's busy share of the
             wall time

`python3 kernel_ab.py SET DIR [DIR ...]` times kernels of several checkouts
on the same inputs: `gemm` the sites' GEMMs, `serve` RMSNorm and decode
(outputs hashed), `rms_plan` each RMSNorm kernel at the serving path's row
counts, `tokens` the `serve` and `ssd_serve` greedy tokens (hashed), `ssd`
the SSD scan's forward and backward (errors against the plain versions),
`norm` the add + RMSNorm forward (hashed), the RMSNorm backward (errors
against fp64) and five `base` steps.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero before that
line; without CUDA, or outside a checkout of the repo, it exits non-zero at
once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory bandwidth (data sheet)
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS_PER_S = 495e12    # H100 SXM dense TF32 tensor-core rate
RMS_TOL = (1e-3, 1.6e-2)     # (atol, rtol): two bf16 ulps of the plain value
# the RMSNorm backward (the add + RMSNorm backward kernel, norm-only or with
# h and d_s) against its plain version: dx within RMS_TOL (bf16; fp32 rows
# within RMS_TOL_FP32, the atol scaled by max(1, max |plain|)), the site's
# dx with one bf16 ulp of its rounded norm gradient more (fuse_add_norm_slack);
# an fp32 dw within RMS_DW_ATOL of its largest |value| (rtol 0): the kernel
# sums a column's rows in another order (a lane's rows, its CTA's teams, the
# CTAs) than torch's reduction, each order rounding at ~1e-7 of the running
# sum over up to 16384 rows, so the limit keeps a ~100x margin, and one
# CTA's rows left out (~47 of 6144) move dw ~1000x past it; and dw must be
# the same bits in two calls
RMS_TOL_FP32 = (1e-5, 1e-5)
RMS_DW_ATOL = 1e-5
# (atol, rtol) of bf16 flash attention: kernel and plain version compute in
# fp32 from the same bf16 inputs and round once, so two bf16 ulps; the atol
# is scaled by the output's largest |value| (gradients grow with the rows
# they sum), at least 1
FLASH_TOL = (1e-3, 1.6e-2)
# bf16 flash gradients are also held tile by tile: in every (batch, head,
# 64-row tile) block -- the kernels' tile at head_dim 128 -- |kernel - plain|
# / |plain| (Frobenius norms) at most one bf16 ulp, 2^-8.  Under the causal
# mask |dV| and |dK| fall along the keys (late keys are summed over fewer
# queries), so an atol scaled by the whole tensor's largest value is a
# sizeable share of a late tile; a norm per tile holds each tile to its own
# scale.  The planted faults below show the limit rejecting a wrong tile
FLASH_GRAD_TILE = 64
FLASH_GRAD_RTOL = 2.0 ** -8
LSE_TOL = (1e-5, 1e-5)       # fp32 log-sum-exp, sums in another order
# the AdamW kernel rounds each operation on its own, as the plain version's
# separate kernels do: at most this many fp32 ulps apart (FMA contraction
# would cost one)
ADAMW_ULPS = 1
# fp32 training parity, card against CPU, after three AdamW steps: the
# parameters at most this far apart, ten times the largest difference read
# on an H100 (5.0e-5).  It cannot see a missing last update (that moves an
# element by about lr = 3e-4), so the step-3 m and v slots are held too:
# within PARITY_SLOT_TOL, ten times the largest error read there (9.9e-5 of
# a slot's largest value, from step-2 and step-3 gradients of parameters
# already that far apart), where one update fewer moves m and v by a third.
# A near-zero gradient whose sign differed by rounding would move its
# element by 2 lr at step 1 and fail the parameter limit on a correct
# kernel; none does at this seed
PARITY_PARAM_ATOL = 5e-4
# rtol, and atol as a share of the tensor's max |value|: step-1 gradients
# (sums in another order) and the step-3 optimizer slots
PARITY_GRAD_TOL = 1e-4
PARITY_SLOT_TOL = 1e-3
TRAIN_STEPS = 5              # steps of the `base` training phase, on one batch
LONGCTX_STEPS = 3            # steps of the `longctx_train` phase
# step 1's loss at `base` in bf16 against the same weights and batch with
# fp32 activations: at most this far apart (prediction in PERF.md)
TRAIN_LOSS_TOL = 1e-2
# `fuse_train`: the fused leg's step-1 loss against the stock leg's.  Both
# are bf16 steps on the same weights and batch that differ only in where
# bf16 rounding lands (sums in another order), so they are held to the same
# TRAIN_LOSS_TOL that bounds bf16 against fp32 activations; the run prints
# stock's own bf16-vs-fp32 gap beside the reading.  The two stock legs run
# the same code on the same inputs: step 1's losses (a forward of
# deterministic kernels) must be equal to the bit, later ones within
# STOCK_LEGS_RTOL (room for any order-dependent sum in a backward); a table
# leaking out of the fused leg's scope moves step 1 already
STOCK_LEGS_RTOL = 1e-4
# (atol, rtol): the same bf16 rounding limit.  Decode outputs are O(sqrt(1/L))
# (0.04-0.05 at L = 1024-2048), so one dropped or double-counted key, or a
# misweighted split in the combine pass, moves them far past it
DECODE_TOL = (1e-3, 1.6e-2)
# first-token logits of generate (B=1, exact length) against the Engine's
# (bucket-padded batched prefill) at 8B widths in bf16: their max |difference|
# over the vocabulary may be at most this multiple of generate's own bf16
# error, its max |difference| from the same prefill with fp32 activations
LOGIT_TOL = 2.0
# the SSD scan kernels against their plain versions, both fp32 (split-TF32
# products, sums and the log-decay prefix sum in another order):
# elementwise |kernel - plain| at most SSD_ATOL x max |plain|, and in every
# g row (one recurrence) |kernel - plain| / |plain| (Frobenius norms of y
# and of the final state; of dx, db, dc and dla) at most SSD_NORM_RTOL.
# Read on an H100 (split-TF32 kernels): forward 1.52e-6 and 1.18e-6, backward
# up to 2.96e-6 and 2.56e-6 (fp32 rounding is 6e-8; the sums run over up to
# L + N = 256 terms), so each limit is 3-8x its reading; the planted faults
# read 0.06 and up
SSD_ATOL = 1e-5
SSD_NORM_RTOL = 1e-5
# the fusion sites' kernels against their plain versions (the site
# references and torch's autograd of them, over cuBLAS products) in bf16:
# both sum in fp32 and round once, but in another order, so an output lands
# on the other side of a bf16 rounding at times, and one flipped ulp of gate
# or up moves everything after it: (atol, rtol) = (1e-3 x max(1, max
# |plain|), two bf16 ulps), as for flash.  Every output is also held per
# 64-row tile by |kernel - plain| / |plain| (Frobenius norms) at most one
# bf16 ulp, 2^-8; the planted faults below show both checks at work
FUSE_TOL = (1e-3, 1.6e-2)
# ... but the add + RMSNorm backward's residual gradient d_s + g (dx, also
# dh) sums the norm's gradient g after kernel and plain have each rounded g
# to bf16 on its own: where the add cancels, one bf16 ulp of g (0.0156 at
# |g| in [2, 4)) is far above two ulps of the sum.  So those two outputs'
# elementwise limit also takes one bf16 ulp of the plain version's rounded
# g at each element (fuse_add_norm_slack)
FUSE_TILE = 64
FUSE_TILE_RTOL = 2.0 ** -8
# fp32 (CUDA cores, no TF32 on either side): sums of up to 32000 terms in
# another order, ~1e-6 of the scale; elementwise atol as a share of max
# |plain|, rtol, and the tile norm limit
FUSE_TOL_FP32 = (1e-5, 1e-5)
FUSE_TILE_RTOL_FP32 = 1e-5
# `base`'s site shapes: batch 3 x seq 2048 rows, hidden, intermediate, vocab
FUSE_M, FUSE_H, FUSE_I, FUSE_V = 3 * 2048, 2048, 5632, 32000
SSD_TRAIN_LAYERS = 8         # depth of `ssd_train` (32 would need 77 GB for params and AdamW)
GATE_ENTRIES = 20            # the JAX registry's 18, ssd_scan_bwd and rms_norm_bwd
SSD_TRAIN_BATCH, SSD_TRAIN_SEQ = 2, 4096
ALL_PHASES = ("card", "build", "kernels", "kernel_gate", "parity", "train", "longctx_train",
              "fuse_train", "ssd_train", "serve", "ssd_serve", "profile")
REPO = Path(__file__).resolve().parent


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed with
    CUDA events after a 64 MiB write that evicts the 50 MB L2 cache (the
    serving path finds its operands cold).  A ~0.5 ms device sleep ahead of
    the start event keeps the host's launch cost out of the interval: the
    host enqueues ``fn`` while the device sleeps."""
    import torch

    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, tol, scaled=False, slack=None):
    """|a - b| <= atol + rtol |b| (+ ``slack``, a tensor of b's shape: a
    further limit at each element); with ``scaled`` the atol is multiplied
    by max(1, max |b|)."""
    atol, rtol = tol
    a, b = a.float(), b.float()
    if scaled:
        atol = atol * max(1.0, float(b.abs().max()))
    limit = atol + rtol * b.abs()
    if slack is not None:
        limit = limit + slack
    return bool(((a - b).abs() <= limit).all())


def max_ulps(a, b):
    """Largest distance in fp32 ulps between same-shaped fp32 tensors (as
    ordered integers: exact for values of one sign)."""
    import torch

    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def tile_rel_err(a, b, tile=FLASH_GRAD_TILE):
    """Largest |a - b| / |b| (Frobenius norms) over the (batch, row tile,
    head) blocks of [B, S, heads, D] tensors; a ragged last tile is padded
    with zero rows, which add to neither norm."""
    import torch.nn.functional as F

    B, S, H, D = b.shape
    pad = -S % tile
    a, b = (F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(B, -1, tile, H, D)
            for x in (a, b))
    num = (a - b).square().sum((2, 4)).sqrt()
    den = b.square().sum((2, 4)).sqrt()
    return float((num / den.clamp_min(1e-30)).max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {line}")
    log(f"torch device: {torch.cuda.get_device_name(0)}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return line


def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.load_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")


def _rms_case(rows, d, gen, w_dtype):
    """bf16 x against a ``w_dtype`` weight: bf16 on the serving path (bf16
    params), fp32 on the training path (fp32 params, bf16 compute)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels.rms_norm import rms_norm, rms_norm_reference

    x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
    y = rms_norm(x, w, 1e-6)
    ref = rms_norm_reference(x, w, 1e-6)
    torch.cuda.synchronize()
    err = max_err(y, ref)
    check(within(y, ref, RMS_TOL), f"rms_norm [{rows},{d}] weight {w_dtype} disagrees: "
          f"max err {err}")
    b_ms, b_by = bound(2 * rows * d * x.element_size() + d * w.element_size(), 4 * rows * d)
    rec = {"shape": [rows, d], "dtype": "bfloat16", "weight_dtype": str(w_dtype)[6:],
           "max_abs_err": err,
           "tol": {"atol": RMS_TOL[0], "rtol": RMS_TOL[1]},
           "ms": time_ms(lambda: rms_norm(x, w, 1e-6)),
           "plain_ms": time_ms(lambda: rms_norm_reference(x, w, 1e-6)),
           "library_ms": time_ms(lambda: F.rms_norm(x, (d,), w, 1e-6)),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"rms_norm {rows}x{d} bf16, weight {rec['weight_dtype']}: {json.dumps(rec)}")
    return rec


def _dw_rejects(got, ref):
    """The RMSNorm backward's dw check: True when ``got`` fails it against
    ``ref`` (fp32: RMS_DW_ATOL of max |ref|; a 2-byte dw: RMS_TOL)."""
    import torch

    if ref.dtype == torch.float32:
        return not within(got, ref, (RMS_DW_ATOL * float(ref.abs().max()), 0.0))
    return not within(got, ref, RMS_TOL)


def _norm_bwd_case(gen, rows, d, dtype, site=False, timed=True, label=""):
    """The RMSNorm backward kernel against its plain version on ``rows``
    rows of ``d`` (``dtype`` rows over an fp32 weight, as the training paths
    pass): norm-only through ``rms_norm_backward`` (the stock RMSNorm's
    backward; plain: ``rms_norm_backward_reference``, what ran on the card
    before), or with ``site`` through ``add_rms_norm_bwd`` with h and d_s
    (the fuse_add_rms_norm backward; plain: autograd of the plain
    reference).  Checks dx and dw (see RMS_DW_ATOL), dw's bits in two
    calls; ``timed``: kernel, plain, stock-chain and library times, bound,
    the kernels' registers and spill bytes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import _build, add_rms_norm as arn, emit
    from paddle_tpu_torch.kernels import rms_norm as rn

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    x, dy = rnd(rows, d), rnd(rows, d)
    w = 1 + 0.1 * rnd(d, dt=torch.float32)
    eps = 1e-6
    if site:
        h, d_s = rnd(rows, d), rnd(rows, d)
        args = (x, h, w, d_s, dy, eps)

        def launch():
            dx, _, dw = arn.add_rms_norm_bwd(*args)
            return dx, dw

        def plain():
            dx, _, dw = arn.add_rms_norm_bwd_reference(*args)
            return dx, dw

        slack = fuse_add_norm_slack((x, h, w), (d_s, dy), {"epsilon": eps})
    else:
        def launch():
            return rn.rms_norm_backward(x, w, dy, eps)

        def plain():
            return rn.rms_norm_backward_reference(x, w, dy, eps)

        slack = None
    before = rn.rms_norm_backward.launches
    got, again, ref = launch(), launch(), plain()
    torch.cuda.synchronize()
    check(rn.rms_norm_backward.launches == before + (0 if site else 2),
          f"rms_norm backward [{rows},{d}]: the stock wrapper's count moved "
          f"{rn.rms_norm_backward.launches - before} for {0 if site else 2} launches")
    kind = "add + RMSNorm (h, d_s)" if site else "norm-only"
    shape = {"rows": rows, "d": d, "dtype": str(dtype)[6:], "weight_dtype": "float32",
             "mode": kind, "label": label}
    fp32 = dtype == torch.float32
    errs = {"dx": max_err(got[0], ref[0]), "dw": max_err(got[1], ref[1]),
            "dw_over_max_abs": max_err(got[1], ref[1]) / max(float(ref[1].abs().max()), 1e-30)}
    dx_ok = within(got[0], ref[0], RMS_TOL_FP32 if fp32 else RMS_TOL, scaled=fp32, slack=slack)
    check(dx_ok and not _dw_rejects(got[1], ref[1]),
          f"rms_norm backward {shape}: disagrees with its plain version: {errs}")
    check(torch.equal(got[1], again[1]) and torch.equal(got[0], again[0]),
          f"rms_norm backward {shape}: two calls differ (dw must be summed in a fixed order)")
    check(bool(torch.isfinite(got[0].float()).all() and torch.isfinite(got[1]).all()),
          f"rms_norm backward {shape}: non-finite output")
    plan = arn.bwd_plan(rows, d, dtype, with_h=site, with_ds=site,
                        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {"shape": shape, "dtype": shape["dtype"], "plan": plan._asdict(),
           "max_abs_err": errs["dx"], "max_abs_err_by_output": errs,
           "tol": {"dx": {"atol": (RMS_TOL_FP32 if fp32 else RMS_TOL)[0],
                          "rtol": (RMS_TOL_FP32 if fp32 else RMS_TOL)[1],
                          "atol_scaled_by_max_abs": fp32,
                          "slack": "one bf16 ulp of the rounded norm gradient" if site else None},
                   "dw": {"atol_over_max_abs": RMS_DW_ATOL, "rtol": 0.0, "bitwise_repeat": True}},
           "ms": None, "plain_ms": None, "stock_chain_ms": None, "library_ms": None,
           "bound_ms": None, "bound_by": None}
    if timed:
        act = rows * d * x.element_size()
        # site: x, h, d_s, d_normed read, ds written once; norm-only: x, dy
        # read, dx written; the weight read and dw written (fp32)
        nbytes = (5 if site else 3) * act + 2 * d * w.element_size()
        b_ms, b_by = bound(nbytes, (14 if site else 10) * rows * d)
        codes = (_build.dtype_code(dtype), _build.dtype_code(w.dtype))
        if plan.kind == "ring":
            main = _build.kernel_attributes("add_rms_norm", 3 if site else 4, *codes, d,
                                            plan.slots * 4 + (3 if site else 0))
        else:
            main = _build.kernel_attributes("add_rms_norm", 1 if site else 5, *codes, d)
        red = _build.kernel_attributes("add_rms_norm", 2 if site else 6, *codes)
        p = [t.detach().requires_grad_() for t in ((x, h, w) if site else (x, w))]
        with torch.enable_grad():
            if site:
                s_ = p[0] + p[1]
                stock_outs, cts = (s_, rn.rms_norm(s_, p[2], eps)), (d_s, dy)
            else:
                stock_outs, cts = (rn.rms_norm(p[0], p[1], eps),), (dy,)
            lib_out = None if site else F.rms_norm(p[0], (d,), p[1], eps)
        rec.update(
            ms=time_ms(launch), plain_ms=time_ms(plain),
            stock_chain_ms=time_ms(lambda: torch.autograd.grad(stock_outs, p, cts,
                                                               retain_graph=True)),
            library_ms=None if site else time_ms(lambda: torch.autograd.grad(
                lib_out, p, dy, retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            registers=main["registers"], spill_bytes=main["local_bytes"],
            smem_bytes=main["static_smem"] + main["dynamic_smem"],
            dw_kernel_registers=red["registers"], dw_kernel_spill_bytes=red["local_bytes"])
        rec["of_bound"] = b_ms / rec["ms"]
        rec["library"] = ("none: no single PyTorch call computes the site's backward" if site
                          else "torch.autograd.grad through F.rms_norm's graph (PyTorch's own "
                               "RMSNorm backward)")
        rec["stock_chain_note"] = ("autograd backward of the stock forward's saved graph: "
                                   "the residual add's and rms_norm's, whose backward is "
                                   "rms_norm_backward")
        del stock_outs, lib_out, p
    log(f"rms_norm backward {json.dumps(rec)}")
    del x, dy, w, got, again, ref
    if site:
        del h, d_s
    torch.cuda.empty_cache()
    return rec


def _norm_bwd_planted_faults(gen, rows=3 * 2048, d=2048):
    """Faults planted in the norm-only backward's outputs at `base`, each of
    which its checks must reject: one row's mean(g x_hat) term dropped from
    dx, and one CTA's rows (as bwd_plan cuts them on this card) left out of
    dw.  Built from the plain version on the same inputs."""
    import torch
    from paddle_tpu_torch.kernels import add_rms_norm as arn
    from paddle_tpu_torch.kernels import rms_norm as rn

    x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    dx, dw = rn.rms_norm_backward_reference(x, w, dy, 1e-6)
    x32, g = x[5:6].float(), dy[5:6].float() * w
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
    bad_dx = dx.clone()
    bad_dx[5] = (r * g).to(dx.dtype)[0]                       # row 5 without its projection
    plan = arn.bwd_plan(rows, d, torch.bfloat16, with_h=False, with_ds=False,
                        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    c = 5
    r0, r1 = c * rows // plan.ctas, (c + 1) * rows // plan.ctas
    _, dw_cta = rn.rms_norm_backward_reference(x[r0:r1], w, dy[r0:r1], 1e-6)
    out = {"dx: row 5's mean(g x_hat) term dropped": {
               "max_abs_err": max_err(bad_dx, dx),
               "rejected": not within(bad_dx, dx, RMS_TOL)},
           f"dw: CTA {c}'s rows {r0}..{r1 - 1} left out": {
               "max_abs_err_over_max_abs": max_err(dw - dw_cta, dw) / float(dw.abs().max()),
               "rejected": _dw_rejects(dw - dw_cta, dw)}}
    for fault, rec in out.items():
        check(rec["rejected"], f"rms_norm backward: the checks pass the planted fault "
                               f"'{fault}': {rec}")
    log(f"rms_norm backward planted faults: {json.dumps(out)}")
    return out


def _decode_bound(lengths, hk, d, h, itemsize, B):
    live = int(sum(lengths))
    nbytes = live * hk * d * 2 * itemsize + 2 * B * h * d * itemsize
    return bound(nbytes, 4 * h * d * live)


def _sdpa_ms(q, k, v, lengths):
    """One library call on the gathered cache: q [B,1,H,D], k/v [B,C,Hk,D]."""
    import torch
    import torch.nn.functional as F

    C = k.shape[1]
    mask = (torch.arange(C, device="cuda")[None, :] < lengths[:, None].long())
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))


def _serve_lengths(seed=0, B=8):
    """The first ``B`` requests of the `serve` phase at their last decode
    step: prompt plus new tokens."""
    from paddle_tpu_torch.models import llama3_8b_config

    reqs = _serve_requests(llama3_8b_config().vocab_size, seed)[0]
    return [len(r.prompt_ids) + r.max_new_tokens for r in reqs[:B]]


def _decode_passes_ms(fn, iters=20):
    """Device ms of each kernel ``fn`` launches (pass 1 and the combine),
    read by torch.profiler over ``iters`` calls, each after the L2 flush of
    ``time_ms``; ``{}`` where the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {("partial" if "partial" in ev.key else "combine"):
            ev.self_device_time_total / 1e3 / ev.count
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and "decode_" in ev.key and ev.count}


def _dense_case(gen, lengths, C=2048, label="table"):
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da

    B, H, Hk, D = len(lengths), 32, 8, 128
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, C, Hk, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, C, Hk, D, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sm = 1.0 / D ** 0.5
    out = da.masked_multihead_attention(q, k, v, lengths)
    ref = da._decode_reference(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(within(out, ref, DECODE_TOL), f"dense decode ({label}) disagrees: max err {err}")
    b_ms, b_by = _decode_bound(lengths.tolist(), Hk, D, H, 2, B)
    rec = {"shape": {"B": B, "C": C, "H": H, "Hk": Hk, "D": D,
                     "lengths": lengths.tolist()}, "dtype": "bfloat16", "lengths_from": label,
           "max_abs_err": err, "tol": {"atol": DECODE_TOL[0], "rtol": DECODE_TOL[1]},
           "ms": time_ms(lambda: da.masked_multihead_attention(q, k, v, lengths)),
           "passes_ms": _decode_passes_ms(lambda: da.masked_multihead_attention(q, k, v, lengths)),
           "plain_ms": time_ms(lambda: da._decode_reference(q, k, v, lengths, sm)),
           "library_ms": _sdpa_ms(q, k, v, lengths),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"decode dense ({label}): {json.dumps(rec)}")
    return rec


def _paged_case(gen, lengths, label="table"):
    """Paged decode over the Engine's pool (512 blocks of 128) and table
    width (8 blocks), NaN in the trash block and in every stale tail."""
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da

    B, NB, H, Hk, bs, D, MAXB = len(lengths), 512, 32, 8, 128, 128, 8
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn(NB, Hk, bs, D, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(NB, Hk, bs, D, generator=gen, device="cuda").to(torch.bfloat16)
    perm = torch.randperm(NB - 1, generator=torch.Generator().manual_seed(1)) + 1
    table = torch.zeros(B, MAXB, dtype=torch.int32)
    nxt = 0
    nan = float("nan")
    kp[0] = nan                       # the trash block
    vp[0] = nan
    for b, L in enumerate(lengths):
        nblk = -(-L // bs)
        table[b, :nblk] = perm[nxt:nxt + nblk].to(torch.int32)
        nxt += nblk
        if L % bs:                    # stale tail of the last live block
            kp[table[b, nblk - 1], :, L % bs:] = nan
            vp[table[b, nblk - 1], :, L % bs:] = nan
    table = table.cuda()
    len_t = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sm = 1.0 / D ** 0.5
    out = da.paged_decode_attention(q, kp, vp, table, len_t)
    ref = da._paged_pool_reference(q, kp, vp, table, len_t, sm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"paged decode ({label}): NaN trash leaked")
    for b, L in enumerate(lengths):
        if L == 0:
            check(bool((out[b] == 0).all()), f"paged decode ({label}): lengths==0 row is not zero")
    err = max_err(out, ref)
    check(within(out, ref, DECODE_TOL), f"paged decode ({label}) disagrees: max err {err}")
    b_ms, b_by = _decode_bound(lengths, Hk, D, H, 2, B)
    kg, vg = da._gather_pool(kp, table), da._gather_pool(vp, table)
    rec = {"shape": {"B": B, "pool": [NB, Hk, bs, D], "maxb": MAXB, "H": H,
                     "lengths": lengths}, "dtype": "bfloat16", "lengths_from": label,
           "max_abs_err": err, "tol": {"atol": DECODE_TOL[0], "rtol": DECODE_TOL[1]},
           "ms": time_ms(lambda: da.paged_decode_attention(q, kp, vp, table, len_t)),
           "passes_ms": _decode_passes_ms(
               lambda: da.paged_decode_attention(q, kp, vp, table, len_t)),
           "plain_ms": time_ms(lambda: da._paged_pool_reference(q, kp, vp, table, len_t, sm)),
           "library_ms": _sdpa_ms(q, kg, vg, len_t),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"decode paged ({label}): {json.dumps(rec)}")
    return rec


def _flash_bounds(B, S, H, Hk, D, itemsize=2):
    """(fwd, bwd) bounds of causal flash attention at bf16 tensor-core rate:
    bytes each input read once and each output written once; operations
    4 D (fwd: q.k, p.v) and 10 D (bwd: q.k again, do.v, p^T do, ds k, ds^T q)
    per visible (query, key) pair."""
    pairs = B * H * S * (S + 1) // 2
    q_bytes = B * S * H * D * itemsize
    kv_bytes = B * S * Hk * D * itemsize
    lse_bytes = B * H * S * 4
    fwd = bound(2 * q_bytes + 2 * kv_bytes + lse_bytes, 4 * D * pairs, BF16_FLOPS_PER_S)
    bwd = bound(4 * q_bytes + 4 * kv_bytes + lse_bytes, 10 * D * pairs, BF16_FLOPS_PER_S)
    return fwd, bwd


def _sdpa_train_ms(q, k, v, do, mode, iters):
    """The library on the same inputs: causal GQA scaled_dot_product_attention,
    ``mode`` "fwd" (its forward), "bwd" (its backward alone: torch.autograd.grad
    over a kept forward) or "fwd+bwd"."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    dot = do.transpose(1, 2)
    if mode == "fwd":
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
    qg, kg, vg = (x.requires_grad_() for x in (qt.clone(), kt.clone(), vt.clone()))
    if mode == "bwd":
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        return time_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), dot, retain_graph=True),
                       iters)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    return time_ms(fwd_bwd, iters)


def _flash_attributes(D):
    """Registers, spill (local) bytes and shared memory of the bf16 flash
    kernels at head dim ``D``, as the card reports them."""
    from paddle_tpu_torch.kernels import _build

    code = _build.dtype_code("bfloat16")
    return {name: _build.kernel_attributes("flash_attention", k, code, D)
            for k, name in enumerate(("flash_fwd_tc_kernel", "flash_bwd_dkdv_tc_kernel",
                                      "flash_bwd_dq_tc_kernel"))}


def _planted_faults(q, k, v, o, lse, do, sm, grads, refs):
    """Faults planted in the kernel's own causal gradients, each of which the
    gradient checks must reject: the diagonal tiles' (query, key) pairs left
    out of dK/dV, one query head left out of its kv-head's dK/dV sum, and
    the last 64 keys' dV 1% off.  The removed parts come from the plain
    backward (it is linear in ``do``, and the diagonal tiles alone are the
    causal backward of each tile's own rows).  Returns, for each fault, each
    faulted gradient's tile error and whether the max-scaled elementwise
    check alone would have passed it."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    T, S = FLASH_GRAD_TILE, q.shape[1]
    dk, dv = (g.float() for g in grads[1:])
    diag_dk, diag_dv = torch.zeros_like(dk), torch.zeros_like(dv)
    for t in range(0, S, T):
        r = slice(t, t + T)
        _, gk, gv = fa._flash_bwd_reference(q[:, r], k[:, r], v[:, r], o[:, r], lse[:, :, r],
                                            do[:, r], True, sm)
        diag_dk[:, r], diag_dv[:, r] = gk.float(), gv.float()
    do_one = torch.zeros_like(do)
    do_one[:, :, 1] = do[:, :, 1]            # query head 1, the second of kv-head 0's group
    _, head_dk, head_dv = fa._flash_bwd_reference(q, k, v, o, lse, do_one, True, sm)
    late_dv = dv.clone()
    late_dv[:, -T:] *= 1.01
    faulted = {"diagonal tiles dropped from dK/dV": {"dk": dk - diag_dk, "dv": dv - diag_dv},
               "query head 1 dropped from kv-head 0's dK/dV sum":
                   {"dk": dk - head_dk.float(), "dv": dv - head_dv.float()},
               "last 64 keys' dV 1% off": {"dv": late_dv}}
    ref = dict(zip(("dq", "dk", "dv"), refs))
    out = {}
    for fault, bad in faulted.items():
        rec = {name: {"tile_norm_err": tile_rel_err(g, ref[name]),
                      "max_scaled_check_passes": within(g, ref[name], FLASH_TOL, scaled=True)}
               for name, g in bad.items()}
        out[fault] = rec
        check(any(r["tile_norm_err"] > FLASH_GRAD_RTOL for r in rec.values()),
              f"flash bwd: the gradient checks pass the planted fault '{fault}': {rec}")
    log(f"flash bwd planted faults: {json.dumps(out)}")
    return out


def _flash_case(gen, B, S, H, Hk, D, heads=None):
    """Flash forward and backward kernels against their plain versions on
    the same bf16 inputs (causal).  ``heads``: hold only the first that many
    query heads (and their kv-heads) against the plain version, which
    cannot run whole at `longctx`; plain times are then not taken.  The
    backward of both gets the plain forward's o and lse for those heads."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(B, S, H, D), rnd(B, S, Hk, D), rnd(B, S, Hk, D), rnd(B, S, H, D)
    sm = D ** -0.5
    hq = heads or H
    hk = hq * Hk // H
    sub = (q[:, :, :hq], k[:, :, :hk], v[:, :, :hk])
    o, lse = fa.flash_attention_fwd(q, k, v, True, sm)
    o_ref, lse_ref = fa._flash_fwd_reference(*sub, True, sm)
    torch.cuda.synchronize()
    shape = {"B": B, "S": S, "H": H, "Hk": Hk, "D": D, "causal": True}
    if heads:
        shape["checked_heads"] = hq
    err_o = max_err(o[:, :, :hq], o_ref)
    err_lse = max_err(lse[:, :hq], lse_ref)
    check(within(o[:, :, :hq], o_ref, FLASH_TOL, scaled=True),
          f"flash fwd {shape}: o disagrees, max err {err_o}")
    check(within(lse[:, :hq], lse_ref, LSE_TOL), f"flash fwd {shape}: lse disagrees, "
          f"max err {err_lse}")
    o_in, lse_in = o.clone(), lse.clone()
    o_in[:, :, :hq] = o_ref
    lse_in[:, :hq] = lse_ref
    grads = fa.flash_attention_bwd(q, k, v, o_in, lse_in, do, True, sm)
    refs = fa._flash_bwd_reference(*sub, o_ref, lse_ref, do[:, :, :hq], True, sm)
    torch.cuda.synchronize()
    errs, tile_errs = {}, {}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        g = g[:, :, :r.shape[2]]
        errs[name] = max_err(g, r)
        tile_errs[name] = tile_rel_err(g, r)
        check(within(g, r, FLASH_TOL, scaled=True), f"flash bwd {shape}: {name} disagrees, "
              f"max err {errs[name]} (max |ref| {float(r.float().abs().max())})")
        check(tile_errs[name] <= FLASH_GRAD_RTOL, f"flash bwd {shape}: {name} disagrees in "
              f"a {FLASH_GRAD_TILE}-row tile by {tile_errs[name]} of its norm")
    faults = None if heads else _planted_faults(q, k, v, o_in, lse_in, do, sm, grads, refs)
    del o_ref, lse_ref, refs
    iters = 20 if heads is None else 3
    attrs = _flash_attributes(D)
    (f_ms, f_by), (b_ms, b_by) = _flash_bounds(B, S, H, Hk, D)
    tol = {"atol": FLASH_TOL[0], "rtol": FLASH_TOL[1], "atol_scaled_by_max_abs": True,
           "grad_tile_rows": FLASH_GRAD_TILE, "grad_tile_norm_rtol": FLASH_GRAD_RTOL}
    fwd = {"shape": shape, "dtype": "bfloat16", "max_abs_err": err_o,
           "max_abs_err_lse": err_lse, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, sm), iters),
           "plain_ms": None if heads else time_ms(
               lambda: fa._flash_fwd_reference(q, k, v, True, sm), iters),
           "library_ms": _sdpa_train_ms(q, k, v, do, "fwd", iters),
           "library": "scaled_dot_product_attention(is_causal, enable_gqa) forward",
           "attributes": {"flash_fwd_tc_kernel": attrs["flash_fwd_tc_kernel"]},
           "bound_ms": f_ms, "bound_by": f_by}
    bwd = {"shape": shape, "dtype": "bfloat16", "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "tile_norm_err_by_grad": tile_errs,
           "planted_faults": faults, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o_in, lse_in, do, True, sm),
                         iters),
           "plain_ms": None if heads else time_ms(
               lambda: fa._flash_bwd_reference(q, k, v, o_in, lse_in, do, True, sm), iters),
           "library_ms": _sdpa_train_ms(q, k, v, do, "bwd", iters),
           "library": "scaled_dot_product_attention's backward alone (torch.autograd.grad "
                      "over a kept forward)",
           "library_fwd_bwd_ms": _sdpa_train_ms(q, k, v, do, "fwd+bwd", iters),
           "attributes": {n: attrs[n] for n in ("flash_bwd_dkdv_tc_kernel",
                                                "flash_bwd_dq_tc_kernel")},
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"flash fwd {shape}: {json.dumps(fwd)}")
    log(f"flash bwd {shape}: {json.dumps(bwd)}")
    return fwd, bwd


def _base_leaf_shapes():
    """The 75 parameter shapes of the `base` preset, in the model's order."""
    from paddle_tpu_torch.models.presets import build_config

    c = build_config("base", "bfloat16")
    qkv = (c.num_attention_heads + 2 * c.kv_heads) * c.head_dim
    layer = [(c.hidden_size,), (c.hidden_size, qkv),
             (c.num_attention_heads * c.head_dim, c.hidden_size), (c.hidden_size,),
             (c.hidden_size, 2 * c.intermediate_size), (c.intermediate_size, c.hidden_size)]
    return ([(c.vocab_size, c.hidden_size)] + layer * c.num_hidden_layers
            + [(c.hidden_size,), (c.hidden_size, c.vocab_size)])


def _ssd_train_leaf_shapes():
    """The 43 parameter shapes of `ssd_train`'s model (ssd_8b widths at
    SSD_TRAIN_LAYERS layers), in the model's order: the embedding, each
    block's norm and mixer (in_proj z | x | B | C | dt, dt_bias, d_skip,
    out_proj), the final norm, the untied head."""
    from paddle_tpu_torch.models import ssd_8b_config

    c = ssd_8b_config(num_hidden_layers=SSD_TRAIN_LAYERS, param_dtype="float32")
    H, nh, P, N = c.hidden_size, c.num_heads, c.head_dim, c.state_size
    layer = [(H,), (H, 2 * nh * P + 2 * nh * N + nh), (nh,), (nh,), (nh * P, H)]
    return ([(c.vocab_size, H)] + layer * c.num_hidden_layers + [(H,)]
            + ([] if c.tie_word_embeddings else [(H, c.vocab_size)]))


def _adamw_case(gen, shapes, label, in_place=False):
    """The AdamW kernel over ``shapes`` (one launch a leaf) against the plain
    version on the same fp32 p, g, m, v, at step 10 of `base`'s AdamW.
    ``in_place``: the timed launches update the leaves themselves, not
    copies (for `ssd_train`'s 2.0 B elements, whose copies would not fit
    beside them)."""
    import torch
    from paddle_tpu_torch.kernels.adamw import adamw_reference, adamw_update

    hyper = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.1)
    lr, step = 3e-4, 10
    leaves = []
    for shp in shapes:
        g = 1e-3 * torch.randn(shp, generator=gen, device="cuda")
        leaves.append((0.02 * torch.randn(shp, generator=gen, device="cuda"), g, 0.3 * g,
                       g * g))
    ulps, err = 0, 0.0
    for p, g, m, v in leaves:
        ref = adamw_reference(p, g, m, v, lr, step, **hyper)
        out = [x.clone() for x in (p, m, v)]
        adamw_update(out[0], g, out[1], out[2], lr, step, **hyper)
        ulps = max(ulps, *(max_ulps(a, b) for a, b in zip(out, ref)))
        err = max(err, *(max_err(a, b) for a, b in zip(out, ref)))
        del ref, out
    n = sum(p.numel() for p, *_ in leaves)
    check(ulps <= ADAMW_ULPS, f"adamw {label}: {ulps} ulps from the plain version")
    b_ms, b_by = bound(28 * n, 12 * n)
    state = [[x if in_place else x.clone() for x in (p, m, v)] for p, g, m, v in leaves]

    def kernel():
        for (p, m, v), (_, g, _, _) in zip(state, leaves):
            adamw_update(p, g, m, v, lr, step, **hyper)

    def plain():
        for p, g, m, v in leaves:
            adamw_reference(p, g, m, v, lr, step, **hyper)

    def library():
        torch._fused_adamw_([s[0] for s in state], [x[1] for x in leaves],
                            [s[1] for s in state], [s[2] for s in state], [], steps,
                            lr=lr, beta1=0.9, beta2=0.999, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False)

    steps = [torch.tensor(float(step), device="cuda") for _ in leaves]
    try:
        lib_ms = time_ms(library)
    except (RuntimeError, TypeError) as e:   # a yardstick only, never a check
        log(f"adamw {label}: torch._fused_adamw_ not timed: {e}")
        lib_ms = None
    rec = {"shape": {"leaves": len(shapes), "elements": n, "label": label},
           "dtype": "float32", "max_abs_err": err, "max_ulps": ulps,
           "tol": {"ulps": ADAMW_ULPS}, "ms": time_ms(kernel), "plain_ms": time_ms(plain),
           "library_ms": lib_ms, "library": "torch._fused_adamw_ over the same leaves",
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"adamw {label}: {json.dumps(rec)}")
    return rec


def _ssd_inputs(gen, G, T, P, N, decay=None):
    """fp32 scan operands: standard normal x, B, C; log-decay -0.1 |n| (a
    per-token decay of ~0.92), or near ``decay`` a token."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    x, b, c = rnd(G, T, P), rnd(G, T, N), rnd(G, T, N)
    la = -0.1 * rnd(G, T).abs() if decay is None else (decay + 0.1 * rnd(G, T)).clamp(max=0.0)
    return x, b, c, la


def _ssd_errors(y, s, y_ref, s_ref):
    """(largest |a - plain| / max |plain| of y and of s, largest per-g
    |a - plain| / |plain| in Frobenius norm of y and of s)."""
    def elem(a, r):
        return max_err(a, r) / max(float(r.abs().max()), 1e-30)

    def norm(a, r):
        d = (a.float() - r.float()).flatten(1).norm(dim=1)
        return float((d / r.float().flatten(1).norm(dim=1).clamp_min(1e-30)).max())

    return max(elem(y, y_ref), elem(s, s_ref)), max(norm(y, y_ref), norm(s, s_ref))


def _ssd_rejects(errs):
    return errs[0] > SSD_ATOL or errs[1] > SSD_NORM_RTOL


def _ssd_planted_faults(x, b, c, la, L, y, s, y_ref, s_ref):
    """Faults planted in the kernel's own outputs, each of which the checks
    must reject: the state not carried across chunks (S reset each chunk),
    the mask off by one (s < t: the diagonal term left out), and the
    inter-chunk term C.S dropped on the last chunk.  The removed parts come
    from the plain scan's states entering each chunk."""
    import torch
    from paddle_tpu_torch.kernels.ssd_scan import ssd_scan_states

    G, T, P = x.shape
    N, nc = b.shape[-1], T // L
    _, states = ssd_scan_states(x, b, c, la, L)
    s_in = torch.stack(states[:-1], dim=1)                                    # [G, nc, N, P]
    cum = la.reshape(G, nc, L).cumsum(-1)
    inter = torch.exp(cum)[..., None] * (c.reshape(G, nc, L, N) @ s_in)      # [G, nc, L, P]
    last = torch.zeros_like(inter)
    last[:, -1] = inter[:, -1]
    faulted = {
        "state not carried across chunks": (
            y - inter.reshape(G, T, P),
            s - torch.exp(cum[:, -1, -1])[:, None, None] * s_in[:, -1]),
        "mask off by one (s < t)": (y - (c * b).sum(-1, keepdim=True) * x, s),
        "C.S dropped on the last chunk": (y - last.reshape(G, T, P), s)}
    out = {}
    for fault, (yf, sf) in faulted.items():
        errs = _ssd_errors(yf, sf, y_ref, s_ref)
        out[fault] = {"max_abs_err_over_max": errs[0], "g_norm_err": errs[1]}
        check(_ssd_rejects(errs), f"ssd_scan: the checks pass the planted fault '{fault}': "
              f"{out[fault]}")
    log(f"ssd_scan planted faults: {json.dumps(out)}")
    return out


def _ssd_grad_errors(got, want):
    """_ssd_errors of each of dx, db, dc, dla: {name: (elementwise over max
    |plain|, largest per-g norm)}."""
    out = {}
    for name, a, r in zip(("dx", "db", "dc", "dla"), got, want):
        def norm(a, r):
            d = (a.float() - r.float()).flatten(1).norm(dim=1)
            return float((d / r.float().flatten(1).norm(dim=1).clamp_min(1e-30)).max())
        out[name] = (max_err(a, r) / max(float(r.abs().max()), 1e-30), norm(a, r))
    return out


def _ssd_grad_rejects(errs):
    return any(_ssd_rejects(e) for e in errs.values())


def _ssd_bwd_faulted(x, b, c, la, states, dy, ds, L, fault):
    """The scan's closed-form VJP (kernels/ssd_scan.py
    ssd_scan_bwd_reference, the same steps) with one planted fault: "carry"
    the state gradient not carried across chunks (each chunk's G' is the
    next chunk's own C^T (e dy) only), "end" dla without the state update's
    chunk-end terms, "mask" dM masked off by one (s < t: the diagonal
    dropped).  With ``fault`` None it is the reference bit for bit, which
    _ssd_bwd_planted_faults checks before it plants a fault."""
    import torch

    G, T, P = x.shape
    N, nc = b.shape[-1], T // L
    xr, dyr = x.reshape(G, nc, L, P), dy.reshape(G, nc, L, P)
    br, cr = b.reshape(G, nc, L, N), c.reshape(G, nc, L, N)
    cum = la.reshape(G, nc, L).double().cumsum(-1)
    tot = cum[..., -1:]
    e, w, a = (torch.exp(v.float()) for v in (cum, tot - cum, tot))
    idx = torch.arange(L, device=x.device)
    mask = idx[None, :] <= idx[:, None]
    decay = torch.where(mask, torch.exp(torch.where(
        mask, cum[..., :, None] - cum[..., None, :], 0.0).float()), 0.0)
    m = (cr @ br.transpose(-1, -2)) * decay
    s_in = states[:, :nc]
    q = (cr * e[..., None]).transpose(-1, -2) @ dyr
    if fault == "carry":          # each chunk's G' its successor's Q alone; the last ds
        g_out = torch.cat([q[:, 1:], ds[:, None]], dim=1)
    else:
        grads = [ds]
        for k in reversed(range(nc)):
            grads.append(a[:, k, :, None] * grads[-1] + q[:, k])
        g_out = torch.stack(grads[-2::-1], dim=1)
    dx = m.transpose(-1, -2) @ dyr + (br * w[..., None]) @ g_out
    dcb = (dyr @ xr.transpose(-1, -2)) * decay
    diag = dcb.diagonal(0, -2, -1)[..., None]
    if fault == "mask":
        diag = torch.zeros_like(diag)
    dcb = torch.where(idx[None, :] < idx[:, None], dcb, 0.0)
    dc_in, db_in = dcb @ br, dcb.transpose(-1, -2) @ cr
    dys = e[..., None] * (dyr @ s_in.transpose(-1, -2))
    xg = w[..., None] * (xr @ g_out.transpose(-1, -2))
    dc, db = dc_in + diag * br + dys, db_in + diag * cr + xg
    wterm = (br * xg).sum(-1)[..., :-1]
    dcum = (cr * (dc_in + dys)).sum(-1) - (br * db_in).sum(-1)
    end = wterm.sum(-1) + a[..., 0] * (g_out * s_in).sum((-1, -2))
    if fault == "end":
        end = torch.zeros_like(end)
    dcum = torch.cat([dcum[..., :-1] - wterm, dcum[..., -1:] + end[..., None]], dim=-1)
    dla = dcum.flip(-1).cumsum(-1).flip(-1)
    return dx.reshape(G, T, P), db.reshape(G, T, N), dc.reshape(G, T, N), dla.reshape(G, T)


def _ssd_bwd_planted_faults(x, b, c, la, dy, ds, L):
    """Faults planted in the backward's plain steps, each of which the
    backward's checks must reject: the state gradient not carried across
    chunks, dla missing its state-update (chunk-end) terms, dM masked off by
    one (the diagonal s = t dropped).  At a tenth of the cases' log-decay
    (-0.01 |n| a token): at -0.1 |n| a 128-token chunk keeps e^-10 of the
    state it is handed, so a carry dropped there moves the gradients by
    less than the limit; at -0.01 |n| it keeps e^-1.  The kernel is held to
    the plain version at that decay too."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    la = la / 10
    _, _, states = ts._launch(x, b, c, la, L)
    ops = (x, b, c, la, states, dy, ds)
    want = ts.ssd_scan_bwd_reference(*ops, L)
    check(all(torch.equal(a, r) for a, r in zip(_ssd_bwd_faulted(*ops, L, None), want)),
          "ssd_scan_bwd: the planted faults' copy of the plain backward is not the plain "
          "backward")
    errs = _ssd_grad_errors(ts.ssd_scan_bwd(*ops, chunk=L), want)
    check(not _ssd_grad_rejects(errs), f"ssd_scan_bwd: at log-decay -0.01 |n| the kernel "
                                       f"disagrees: {errs}")
    out = {"kernel at this decay": errs}
    for fault, label in (("carry", "state gradient not carried across chunks"),
                         ("end", "dla missing its state-update term"),
                         ("mask", "dM masked off by one (s < t)")):
        errs = _ssd_grad_errors(_ssd_bwd_faulted(*ops, L, fault), want)
        out[label] = errs
        check(_ssd_grad_rejects(errs), f"ssd_scan_bwd: the checks pass the planted fault "
                                       f"'{label}': {errs}")
    log(f"ssd_scan_bwd planted faults: {json.dumps(out)}")
    return out


def _ssd_bwd_bound(G, T, P, N, L):
    """(bytes, flops) of the backward: x, b, c, la, dy, ds and the saved
    states entering each chunk (nc of the nc + 1: the final one is not read)
    read once, dx, db, dc, dla written once (three [G, T, P], four [G, T, N],
    two [G, T]); a chunk's 3 L (L + 1) N (C B^T, dCB B, dCB^T C over the
    causal entries) + 2 L (L + 1) P (M^T dy, dy x^T) + 8 L N P (C^T (e dy),
    (B w) G', dy S^T, x G'^T) flops."""
    nc = T // L
    nbytes = 4 * (3 * G * T * P + 4 * G * T * N + 2 * G * T + G * nc * N * P + G * N * P)
    flops = G * nc * (3 * L * (L + 1) * N + 2 * L * (L + 1) * P + 8 * L * N * P)
    return nbytes, flops


def _ssd_case(gen, G, T, P, N, L, full):
    """The SSD scan's forward and backward kernels against their plain
    versions (fp32) at one shape: errors within ``SSD_ATOL`` /
    ``SSD_NORM_RTOL`` (the backward: each of dx, db, dc, dla); zero rows
    (inside the last chunk and a whole extra chunk) bitwise no-ops, and in
    the backward zero gradients that leave every other one's bits; a
    log-decay near -20 a token finite and within the limits; with ``full``
    the planted faults.  The fp32 plain backward's own error against fp64 is
    logged beside.  Returns (forward record, backward record)."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    x, b, c, la = _ssd_inputs(gen, G, T, P, N)
    y, s = ts.ssd_scan(x, b, c, la, chunk=L)
    y_ref, s_ref = ts.ssd_scan_reference(x, b, c, la, L)
    torch.cuda.synchronize()
    shape = {"G": G, "T": T, "P": P, "N": N, "L": L}
    errs = _ssd_errors(y, s, y_ref, s_ref)
    check(bool(torch.isfinite(y).all() and torch.isfinite(s).all()), f"ssd_scan {shape}: not finite")
    check(not _ssd_rejects(errs), f"ssd_scan {shape}: disagrees with the plain scan: max err "
          f"{errs[0]} of max |plain| (limit {SSD_ATOL}), g-row norm err {errs[1]} "
          f"(limit {SSD_NORM_RTOL})")
    zeros = [t.clone() for t in (x, b, c, la)]
    for t in zeros:
        t[:, T - 5:] = 0
    y0, s0 = ts.ssd_scan(*zeros, chunk=L)
    y1, s1 = ts.ssd_scan(*[torch.cat([t, torch.zeros_like(t[:, :L])], dim=1) for t in zeros],
                         chunk=L)
    check(torch.equal(y0, y1[:, :T]) and torch.equal(s0, s1),
          f"ssd_scan {shape}: zero rows are not exact no-ops")
    x20, b20, c20, la20 = _ssd_inputs(gen, min(G, 16), T, P, N, decay=-20.0)
    y20, s20 = ts.ssd_scan(x20, b20, c20, la20, chunk=L)
    errs20 = _ssd_errors(y20, s20, *ts.ssd_scan_reference(x20, b20, c20, la20, L))
    check(bool(torch.isfinite(y20).all() and torch.isfinite(s20).all()),
          f"ssd_scan {shape}: log-decay near -20 gives non-finite values")
    check(not _ssd_rejects(errs20), f"ssd_scan {shape}: log-decay near -20 disagrees: {errs20}")
    faults = _ssd_planted_faults(x, b, c, la, L, y, s, y_ref, s_ref) if full else None

    # the backward: the kernels against the plain closed form on the same
    # inputs, the forward kernels' states and the same cotangents
    _, _, states = ts._launch(x, b, c, la, L)
    dy, ds = (torch.randn(t.shape, generator=gen, device="cuda") for t in (y, s))
    ops = (x, b, c, la, states, dy, ds)
    got = ts.ssd_scan_bwd(*ops, chunk=L)
    want = ts.ssd_scan_bwd_reference(*ops, L)
    torch.cuda.synchronize()
    berrs = _ssd_grad_errors(got, want)
    check(all(bool(torch.isfinite(g).all()) for g in got), f"ssd_scan_bwd {shape}: not finite")
    check(not _ssd_grad_rejects(berrs), f"ssd_scan_bwd {shape}: disagrees with the plain "
          f"backward: {berrs} (limits {SSD_ATOL}, {SSD_NORM_RTOL})")
    # zero rows (dy 0 there, ds 0): zero gradients, and an appended zero
    # chunk changes no bit of the others
    zs = [t.clone() for t in (x, b, c, la, dy)]
    for t in zs:
        t[:, T - 5:] = 0

    def zgrads(x, b, c, la, dy):
        _, s, st = ts._launch(x, b, c, la, L)
        return ts.ssd_scan_bwd(x, b, c, la, st, dy, torch.zeros_like(s), chunk=L)

    g0 = zgrads(*zs)
    g1 = zgrads(*[torch.cat([t, torch.zeros_like(t[:, :L])], dim=1) for t in zs])
    check(all(torch.equal(a, r[:, :T]) and bool((r[:, T - 5:] == 0).all())
              for a, r in zip(g0, g1)),
          f"ssd_scan_bwd {shape}: zero rows do not give exact zero gradients and no-ops")
    del g0, g1, zs
    _, _, st20 = ts._launch(x20, b20, c20, la20, L)
    ops20 = (x20, b20, c20, la20, st20, dy[:x20.shape[0]], ds[:x20.shape[0]])
    got20 = ts.ssd_scan_bwd(*ops20, chunk=L)
    berrs20 = _ssd_grad_errors(got20, ts.ssd_scan_bwd_reference(*ops20, L))
    check(all(bool(torch.isfinite(g).all()) for g in got20),
          f"ssd_scan_bwd {shape}: log-decay near -20 gives non-finite gradients")
    check(not _ssd_grad_rejects(berrs20),
          f"ssd_scan_bwd {shape}: log-decay near -20 disagrees: {berrs20}")
    # the fp32 plain backward's own error against fp64, at both decays
    fp64 = {}
    for label, o in (("decay_0.1", ops), ("decay_near_minus_20", ops20)):
        x_, b_, c_, la_, _, dy_, ds_ = o
        _, st32 = ts.ssd_scan_states(x_, b_, c_, la_, L)
        plain32 = ts.ssd_scan_bwd_reference(x_, b_, c_, la_, torch.stack(st32, 1), dy_, ds_, L)
        o64 = [t.double() for t in (x_, b_, c_, la_)]
        _, st64 = ts.ssd_scan_states(*o64, L)
        plain64 = ts.ssd_scan_bwd_reference(*o64, torch.stack(st64, 1), dy_.double(),
                                            ds_.double(), L)
        fp64[label] = _ssd_grad_errors(plain32, plain64)
        del plain32, plain64, st32, st64, o64
    bfaults = _ssd_bwd_planted_faults(x, b, c, la, dy, ds, L) if full else None

    plain_bwd_ms = time_ms(lambda: ts.ssd_scan_bwd_reference(*ops, L), 5)
    # the backward before the scan had a backward kernel: autograd through a
    # recompute of the plain scan (the forward record's plain_backward_ms)
    args = [t.detach().requires_grad_() for t in (x, b, c, la)]

    def recompute_backward():
        with torch.enable_grad():
            yy, ss = ts.ssd_scan_reference(*args, L)
        torch.autograd.grad((yy, ss), args, (dy, ds))
    nbytes = 4 * (2 * G * T * P + 2 * G * T * N + G * T + G * N * P)
    # a chunk: C.B^T and M.x over the L(L+1)/2 entries with s <= t (the
    # causal mask needs no others), C.S and the state update in full
    flops = G * (T // L) * (L * (L + 1) * (N + P) + 4 * L * N * P)
    b_ms, b_by = bound(nbytes, flops)
    tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    rec = {"shape": shape, "dtype": "float32", "max_abs_err": max_err(y, y_ref),
           "max_abs_err_state": max_err(s, s_ref), "max_err_over_max_abs": errs[0],
           "g_norm_err": errs[1], "zero_rows_bitwise": True,
           "decay_near_minus_20": {"max_err_over_max_abs": errs20[0], "g_norm_err": errs20[1]},
           "planted_faults": faults,
           "tol": {"atol_over_max_abs": SSD_ATOL, "g_norm_rtol": SSD_NORM_RTOL},
           "ms": time_ms(lambda: ts.ssd_scan(x, b, c, la, chunk=L)),
           "plain_ms": time_ms(lambda: ts.ssd_scan_reference(x, b, c, la, L)),
           "library_ms": None,
           "library": "none: no single PyTorch call computes the chunked scan",
           "plain_backward_ms": time_ms(recompute_backward, 5),
           "bound_ms": b_ms, "bound_by": b_by, "bound_tf32x3_ms": tc_ms, "bound_tf32x3_by": tc_by,
           "bytes": nbytes, "flops": flops}
    log(f"ssd_scan {shape}: {json.dumps(rec)}")
    nbytes, flops = _ssd_bwd_bound(G, T, P, N, L)
    b_ms, b_by = bound(nbytes, flops)
    tc_ms, tc_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    brec = {"shape": shape, "dtype": "float32",
            "max_abs_err": max(max_err(a, r) for a, r in zip(got, want)),
            "max_abs_err_by_output": {n: max_err(a, r) for n, a, r in
                                      zip(("dx", "db", "dc", "dla"), got, want)},
            "errors": berrs, "decay_near_minus_20": berrs20, "plain_fp32_vs_fp64": fp64,
            "zero_rows_bitwise": True, "planted_faults": bfaults,
            "tol": {"atol_over_max_abs": SSD_ATOL, "g_norm_rtol": SSD_NORM_RTOL},
            "ms": time_ms(lambda: ts.ssd_scan_bwd(*ops, chunk=L)),
            "plain_ms": plain_bwd_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes the scan's VJP",
            "bound_ms": b_ms, "bound_by": b_by, "bound_tf32x3_ms": tc_ms,
            "bound_tf32x3_by": tc_by, "bytes": nbytes, "flops": flops}
    log(f"ssd_scan_bwd {shape}: {json.dumps(brec)}")
    return rec, brec


def rows_tile_err(a, b, tile=FUSE_TILE):
    """Largest |a - b| / |b| (Frobenius norms) over the ``tile``-row blocks
    of 2-D tensors (a vector is one row); a ragged last tile is padded with
    zero rows, which add to neither norm."""
    import torch.nn.functional as F

    a, b = (x.float().reshape(-1, x.shape[-1]) for x in (a, b))
    pad = -b.shape[0] % tile
    a, b = (F.pad(x, (0, 0, 0, pad)).reshape(-1, tile, x.shape[-1]) for x in (a, b))
    num = (a - b).square().sum((1, 2)).sqrt()
    return float((num / b.square().sum((1, 2)).sqrt().clamp_min(1e-30)).max())


def _fuse_rejects(got, ref, fp32, slack=None):
    """The fusion checks: True when ``got`` fails them against ``ref``
    (``slack``: a further elementwise limit, see FUSE_TOL)."""
    tol, tile = (FUSE_TOL_FP32, FUSE_TILE_RTOL_FP32) if fp32 else (FUSE_TOL, FUSE_TILE_RTOL)
    if fp32:
        tol = (tol[0] * max(float(ref.float().abs().max()), 1e-30), tol[1])
    return (not within(got, ref, tol, scaled=not fp32, slack=slack)
            or rows_tile_err(got, ref) > tile)


def fuse_add_norm_slack(args, cts, static):
    """One bf16 ulp, at each element, of the add + RMSNorm site's norm
    gradient g as the plain version rounds it before the residual add
    (``emit.add_norm_slack``, which the kernel gate's limit takes too): the
    further limit of that backward's dx and dh (FUSE_TOL).  None for fp32
    rows, which round nothing."""
    import torch
    from paddle_tpu_torch.kernels import emit

    if args[0].dtype == torch.float32:
        return None
    return emit.add_norm_slack(*args, *cts, epsilon=static["epsilon"])


def _site_args(gen, name, M, dtype, transpose=False, device="cuda"):
    """A site's operands at `base` widths, ``M`` rows of ``dtype``
    activations, fp32 weights at the model's init scale: hidden rows N(0, 1)
    (N(0, 4) before the final norm, whose inverse RMS is then ~0.5), norm
    weights 1 + N(0, 0.01), projections N(0, 0.02^2)."""
    import torch

    def rnd(*shape, std=1.0, dt=torch.float32):
        return (std * torch.randn(*shape, generator=gen, device=device)).to(dt)

    H, I, V = FUSE_H, FUSE_I, FUSE_V
    if name == "fuse_swiglu_mlp":
        return (rnd(M, H, dt=dtype), rnd(H, 2 * I, std=0.02), rnd(I, H, std=0.02)), \
            {"intermediate_size": I}
    if name == "fuse_add_rms_norm":
        return (rnd(M, H, dt=dtype), rnd(M, H, dt=dtype), 1 + rnd(H, std=0.1)), {"epsilon": 1e-6}
    w_head = rnd(V, H, std=0.02) if transpose else rnd(H, V, std=0.02)
    return (rnd(M, H, std=2.0, dt=dtype), 1 + rnd(H, std=0.1), w_head), \
        {"epsilon": 1e-6, "transpose": transpose}


def _stock_chain(name, args, static):
    """The seam's stock path, which the site replaces: cuBLAS products and
    torch elementwise ops, with the RMSNorm kernel where the model has it."""
    from paddle_tpu_torch.kernels.rms_norm import rms_norm
    from paddle_tpu_torch.models.llama import mlp_fn

    if name == "fuse_swiglu_mlp":
        return mlp_fn(*args, static["intermediate_size"])
    if name == "fuse_add_rms_norm":
        s = args[0] + args[1]
        return s, rms_norm(s, args[2], static["epsilon"])
    hidden, w_norm, w_head = args
    normed = rms_norm(hidden, w_norm, static["epsilon"])
    wh = w_head.to(normed.dtype)
    return normed @ (wh.T if static["transpose"] else wh)


def _site_bounds(name, M, itemsize):
    """(forward, backward) bounds of a site at `base` widths: bytes with
    each input read once and each output written once (fp32 weights and
    weight gradients), operations at the bf16 tensor-core rate (fp32 rate
    for fp32 activations, and for the add + norm's few flops an element)."""
    H, I, V = FUSE_H, FUSE_I, FUSE_V
    rate = BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S
    act = M * H * itemsize
    if name == "fuse_swiglu_mlp":
        w = 3 * H * I * 4
        mm = 2 * M * H * I                     # one [M, H] x [H, I] product
        # forward: gate_up (2 mm) + down (1 mm); backward: gate_up again,
        # d_act, dW_down, d_hidden (2 mm), dW_gate_up (2 mm)
        return (bound(2 * act + w, 3 * mm, rate), bound(3 * act + 2 * w, 8 * mm, rate))
    if name == "fuse_add_rms_norm":
        # backward: x, h, d_s, d_normed read; ds written once (it is dx and dh)
        return (bound(4 * act + H * 4, 5 * M * H), bound(5 * act + 2 * H * 4, 14 * M * H))
    logits = M * V * itemsize
    mm = 2 * M * H * V
    return (bound(act + H * 4 + H * V * 4 + logits, mm, rate),
            bound(2 * act + 2 * H * 4 + 2 * H * V * 4 + logits, 2 * mm, rate))


def _fuse_planted_faults(gen, M=FUSE_M, device="cuda"):
    """Faults planted in the sites' outputs at `base` widths (``M`` rows),
    each of which the fusion checks must reject: the gate and up halves
    swapped, the down product's last K tile (32 of 5632) dropped, one row's
    RMS scale skipped in the head's prologue, and one row's norm gradient
    dropped from the add + RMSNorm backward's dx (held with that output's
    further limit, fuse_add_norm_slack).  Each is built from the plain
    pieces on the same inputs and held against the plain output."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import emit

    (x, w_gu, w_d), st = _site_args(gen, "fuse_swiglu_mlp", M, torch.bfloat16, device=device)
    I = st["intermediate_size"]
    ref = emit._swiglu_ref(x, w_gu, w_d, intermediate_size=I)
    gate, up = torch.split(x @ w_gu.to(x.dtype), [I, I], dim=-1)
    act = F.silu(gate) * up
    wd = w_d.to(x.dtype)
    faults = {"gate and up halves swapped": (F.silu(up) * gate) @ wd,
              "down product's last K tile dropped": act[:, :-32] @ wd[:-32]}
    refs = {k: ref for k in faults}
    slacks = {}
    (hid, w_n, w_h), st = _site_args(gen, "fuse_rms_norm_head", M, torch.bfloat16,
                                     device=device)
    logits = emit._rms_norm_head_ref(hid, w_n, w_h, **st)
    bad = logits.clone()
    unscaled = (hid[5].float() * w_n).to(hid.dtype)           # row 5 without its 1/RMS
    bad[5] = unscaled @ w_h.to(hid.dtype)
    faults["one row's RMS scale skipped"] = bad
    refs["one row's RMS scale skipped"] = logits
    args, st = _site_args(gen, "fuse_add_rms_norm", M, torch.bfloat16, device=device)
    site = emit.SITES["fuse_add_rms_norm"]
    cts = tuple(torch.randn(a.shape, generator=gen, device=device).to(a.dtype)
                for a in args[:2])
    dx = emit._vjp_reference(site, args, cts, st)[0]
    bad = dx.clone()
    bad[5] = cts[0][5]                                        # row 5 without its norm gradient
    fault = "one row's norm gradient dropped (add + RMSNorm dx)"
    faults[fault], refs[fault] = bad, dx
    slacks[fault] = fuse_add_norm_slack(args, cts, st)
    out = {}
    for fault, got in faults.items():
        r = refs[fault]
        out[fault] = {"tile_norm_err": rows_tile_err(got, r),
                      "elementwise_check_passes": within(got, r, FUSE_TOL, scaled=True,
                                                         slack=slacks.get(fault))}
        check(_fuse_rejects(got, r, False, slacks.get(fault)),
              f"fusion sites: the checks pass the planted fault '{fault}': {out[fault]}")
    log(f"fusion planted faults: {json.dumps(out)}")
    return out


def _site_case(gen, name, M, dtype, transpose=False, timed=False):
    """A site's forward and backward kernels (``emit._FORWARD`` /
    ``emit._BACKWARD``, the launches ``make_fused`` makes) against the plain
    reference and torch's autograd of it, on the same inputs and
    cotangents.  ``timed``: kernel, plain and stock-chain times, bounds."""
    import torch
    from paddle_tpu_torch.kernels import emit

    site = emit.SITES[name]
    args, st = _site_args(gen, name, M, dtype, transpose)
    fp32 = dtype == torch.float32
    outs = emit._as_tuple(emit._FORWARD[name](*args, **st))
    refs = emit._as_tuple(site.ref(*args, **st))
    cts = tuple(torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype) for r in refs)
    grads = emit._BACKWARD[name](args, cts, **st)
    want = emit._vjp_reference(site, args, cts, st)
    torch.cuda.synchronize()
    shape = {"M": M, "H": FUSE_H, "dtype": str(dtype)[6:], "weights": "float32"}
    shape.update({"I": FUSE_I} if name == "fuse_swiglu_mlp" else
                 {"V": FUSE_V, "tied": transpose} if name == "fuse_rms_norm_head" else {})
    # the add + RMSNorm backward's dx and dh: one bf16 ulp of the rounded
    # norm gradient more (FUSE_TOL)
    slack = fuse_add_norm_slack(args, cts, st) if name == "fuse_add_rms_norm" else None
    recs = []
    for direction, got, ref in (("forward", outs, refs), ("backward", grads, want)):
        errs = [max_err(g, r) for g, r in zip(got, ref)]
        tiles = [rows_tile_err(g, r) for g, r in zip(got, ref)]
        for i, (g, r) in enumerate(zip(got, ref)):
            check(g.dtype == r.dtype and g.shape == r.shape,
                  f"{name} {direction} {shape}: output {i} is {g.dtype} {tuple(g.shape)}, plain "
                  f"{r.dtype} {tuple(r.shape)}")
            extra = slack if direction == "backward" and i < 2 else None
            check(not _fuse_rejects(g, r, fp32, extra),
                  f"{name} {direction} {shape}: output {i} disagrees: max err {errs[i]} (max "
                  f"|plain| {float(r.float().abs().max())}), {FUSE_TILE}-row tile norm err "
                  f"{tiles[i]}")
        recs.append({"shape": shape, "dtype": shape["dtype"], "max_abs_err": max(errs),
                     "max_abs_err_by_output": errs, "tile_norm_err_by_output": tiles,
                     "tol": {"atol": (FUSE_TOL_FP32 if fp32 else FUSE_TOL)[0],
                             "rtol": (FUSE_TOL_FP32 if fp32 else FUSE_TOL)[1],
                             "atol_scaled_by_max_abs": True, "tile_rows": FUSE_TILE,
                             "tile_norm_rtol": FUSE_TILE_RTOL_FP32 if fp32 else FUSE_TILE_RTOL},
                     "ms": None, "plain_ms": None, "stock_chain_ms": None,
                     "library_ms": None,
                     "library": "none: no single PyTorch call computes the site; stock_chain_ms "
                                "is the seam's stock path (cuBLAS products + elementwise ops), "
                                "not one call",
                     "bound_ms": None, "bound_by": None})
    if timed:
        (f_ms, f_by), (b_ms, b_by) = _site_bounds(name, M, 2 if dtype == torch.bfloat16 else 4)
        p = [a.detach().requires_grad_() for a in args]
        with torch.enable_grad():
            stock_outs = emit._as_tuple(_stock_chain(name, p, st))
        recs[0].update(
            ms=time_ms(lambda: emit._FORWARD[name](*args, **st)),
            plain_ms=time_ms(lambda: site.ref(*args, **st)),
            stock_chain_ms=time_ms(lambda: _stock_chain(name, args, st)),
            bound_ms=f_ms, bound_by=f_by)
        recs[1].update(
            ms=time_ms(lambda: emit._BACKWARD[name](args, cts, **st)),
            plain_ms=time_ms(lambda: emit._vjp_reference(site, args, cts, st)),
            stock_chain_ms=time_ms(lambda: torch.autograd.grad(stock_outs, p, cts,
                                                               retain_graph=True)),
            bound_ms=b_ms, bound_by=b_by)
        recs[1]["stock_chain_note"] = "autograd backward of the stock forward's saved graph"
        del stock_outs, p
    for direction, rec in zip(("forward", "backward"), recs):
        log(f"{name} {direction} {shape}: {json.dumps(rec)}")
    return recs


def _gemm_products(gen):
    """Each bf16 GEMM launch of the sites at `base` timed on its own, on
    operands already in bf16 (the weights rounded, the head's rows normed):
    ms, TFLOP/s, bound, the card's registers and spill bytes, and one
    torch.matmul on the same operands as the yardstick (``library_ms``; the
    port never calls it); each product also held to the fusion checks
    against its plain version.  Then the two preparation passes (the
    head's fp32 weight rounded, the head's rows normed), against their
    plain versions bit for bit, with the torch cast as their yardstick.
    Returns ``{site: [record, ...]}``."""
    import torch
    from paddle_tpu_torch.kernels import _build, emit
    from paddle_tpu_torch.kernels import fused_gemm as fg

    M, H, I, V = FUSE_M, FUSE_H, FUSE_I, FUSE_V
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(*shape, std=1.0, dt=bf):
        return (std * torch.randn(*shape, generator=gen, device="cuda")).to(dt)

    x, dy, act = rnd(M, H), rnd(M, H), rnd(M, I)
    d_gu, normed, d_logits = rnd(M, 2 * I), rnd(M, H), rnd(M, V)
    wgu, wd, wh = rnd(H, 2 * I, std=0.02), rnd(I, H, std=0.02), rnd(H, V, std=0.02)
    # (site, product, launch, plain, yardstick, layout (a_t, b_t, epilogue), M, N, K, bytes)
    S, SB = fg._EPI_SWIGLU, fg._EPI_SWIGLU_BWD
    products = [
        ("fuse_swiglu_mlp", "gate_up+swiglu", lambda: fg.swiglu_gate_up(x, wgu, I),
         lambda: fg.swiglu_gate_up_reference(x, wgu, I), lambda: torch.matmul(x, wgu),
         (0, 0, S), M, I, H, 2 * (M * H + H * 2 * I + M * I)),
        ("fuse_swiglu_mlp", "down", lambda: fg.matmul(act, wd),
         lambda: fg.matmul_reference(act, wd), lambda: torch.matmul(act, wd),
         (0, 0, 0), M, H, I, 2 * (M * I + I * H + M * H)),
        ("fuse_swiglu_mlp_bwd", "d_act", lambda: fg.matmul(dy, wd, b_t=True),
         lambda: fg.matmul_reference(dy, wd, b_t=True), lambda: torch.matmul(dy, wd.T),
         (0, 1, 0), M, I, H, 2 * (M * H + I * H + M * I)),
        ("fuse_swiglu_mlp_bwd", "gate_up+swiglu_bwd",
         lambda: fg.swiglu_gate_up_bwd(x, wgu, act, I),
         lambda: fg.swiglu_gate_up_bwd_reference(x, wgu, act, I), lambda: torch.matmul(x, wgu),
         (0, 0, SB), M, I, H, 2 * (M * H + H * 2 * I + 2 * M * I + M * 2 * I)),
        ("fuse_swiglu_mlp_bwd", "d_w_down", lambda: fg.matmul(act, dy, a_t=True, out_dtype=f32),
         lambda: fg.matmul_reference(act, dy, a_t=True, out_dtype=f32),
         lambda: torch.matmul(act.T, dy), (1, 0, 0), I, H, M, 2 * (M * I + M * H) + 4 * I * H),
        ("fuse_swiglu_mlp_bwd", "d_hidden", lambda: fg.matmul(d_gu, wgu, b_t=True),
         lambda: fg.matmul_reference(d_gu, wgu, b_t=True), lambda: torch.matmul(d_gu, wgu.T),
         (0, 1, 0), M, H, 2 * I, 2 * (M * 2 * I + H * 2 * I + M * H)),
        ("fuse_swiglu_mlp_bwd", "d_w_gate_up",
         lambda: fg.matmul(x, d_gu, a_t=True, out_dtype=f32),
         lambda: fg.matmul_reference(x, d_gu, a_t=True, out_dtype=f32),
         lambda: torch.matmul(x.T, d_gu), (1, 0, 0), H, 2 * I, M,
         2 * (M * H + M * 2 * I) + 4 * H * 2 * I),
        ("fuse_rms_norm_head", "head", lambda: fg.matmul(normed, wh),
         lambda: fg.matmul_reference(normed, wh), lambda: torch.matmul(normed, wh),
         (0, 0, 0), M, V, H, 2 * (M * H + H * V + M * V)),
        ("fuse_rms_norm_head_bwd", "d_normed", lambda: fg.matmul(d_logits, wh, b_t=True),
         lambda: fg.matmul_reference(d_logits, wh, b_t=True),
         lambda: torch.matmul(d_logits, wh.T), (0, 1, 0), M, H, V, 2 * (M * V + H * V + M * H)),
        ("fuse_rms_norm_head_bwd", "d_w_head",
         lambda: fg.matmul(normed, d_logits, a_t=True, out_dtype=f32),
         lambda: fg.matmul_reference(normed, d_logits, a_t=True, out_dtype=f32),
         lambda: torch.matmul(normed.T, d_logits), (1, 0, 0), H, V, M,
         2 * (M * H + M * V) + 4 * H * V),
    ]
    out = {}
    code = _build.dtype_code(bf)
    for site, name, launch, plain, yard, (a_t, b_t, epi), m, n, k, nbytes in products:
        got, ref = emit._as_tuple(launch()), emit._as_tuple(plain())
        for g, r in zip(got, ref):
            check(not _fuse_rejects(g, r, False),
                  f"{name} at base: max err {max_err(g, r)} (max |plain| "
                  f"{float(r.float().abs().max())}), tile norm err {rows_tile_err(g, r)}")
        flops = 2 * m * n * k * (2 if epi else 1)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        ms = time_ms(launch)
        at = _build.kernel_attributes("fused_gemm", 2, code, 0,
                                      a_t | (1 - b_t) << 1 | epi << 2)
        rec = {"product": name, "M": m, "N": n, "K": k,
               "layout": ("T" if a_t else "N") + ("T" if b_t else "N"),
               "epilogue": ("store", "swiglu", "swiglu_bwd")[epi], "gflop": flops / 1e9,
               "ms": ms, "tflops": flops / ms / 1e9, "bound_ms": b_ms, "bound_by": b_by,
               "of_bound": b_ms / ms, "library_ms": time_ms(yard),
               "library": "torch.matmul of the same bf16 operands (no epilogue)",
               "max_abs_err": max(max_err(g, r) for g, r in zip(got, ref)),
               "registers": at["registers"], "spill_bytes": at["local_bytes"],
               "smem_bytes": at["static_smem"] + at["dynamic_smem"]}
        log(f"fused GEMM {site} {name}: {json.dumps(rec)}")
        out.setdefault(site, []).append(rec)
    w32 = torch.randn(H, V, generator=gen, device="cuda")
    r = 0.5 + torch.rand(M, generator=gen, device="cuda")
    w_norm = 1 + 0.1 * torch.randn(H, generator=gen, device="cuda")
    passes = [("fuse_rms_norm_head", "round w_head (fp32 [2048, 32000])",
               lambda: fg.to_compute(w32, bf), lambda: w32.to(bf), H * V * 6, (0, 0)),
              ("fuse_rms_norm_head", "normed rows ([6144, 2048] bf16)",
               lambda: fg._prep(x, (r, w_norm, "a")),
               lambda: ((x.float() * r[:, None]) * w_norm).to(bf), M * H * 4 + M * 4 + H * 4,
               (code, 1))]
    for site, name, launch, plain, nbytes, (dt, scale) in passes:
        got, ref = launch(), plain()
        check(torch.equal(got, ref), f"the preparation pass {name} is not bitwise its plain version")
        b_ms, b_by = bound(nbytes, 0)
        at = _build.kernel_attributes("fused_gemm", 3, dt, scale)
        rec = {"product": f"prep_kernel: {name}", "ms": time_ms(launch), "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": time_ms(plain),
               "library": "the torch ops of the plain version", "max_abs_err": 0.0,
               "registers": at["registers"], "spill_bytes": at["local_bytes"]}
        rec["of_bound"] = b_ms / rec["ms"]
        log(f"fused GEMM {site} {name}: {json.dumps(rec)}")
        out[site].append(rec)
    del x, dy, act, d_gu, normed, d_logits, wgu, wd, wh, w32
    torch.cuda.empty_cache()
    return out


def phase_fuse_kernels(gen):
    """Every fusion site's kernels at `base` (timed), at a ragged row count
    (1000 rows, not a multiple of the 128-row tile), the tied head, and in
    fp32 at 520 rows; then the planted faults."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {}
    for name in ("fuse_swiglu_mlp", "fuse_add_rms_norm", "fuse_rms_norm_head"):
        runs = [_site_case(gen, name, FUSE_M, torch.bfloat16, timed=True),
                _site_case(gen, name, 1000, torch.bfloat16),
                _site_case(gen, name, 520, torch.float32)]
        if name == "fuse_rms_norm_head":
            runs.append(_site_case(gen, name, FUSE_M, torch.bfloat16, transpose=True))
        cases[name] = [r[0] for r in runs]
        cases[name + "_bwd"] = [r[1] for r in runs]
        torch.cuda.empty_cache()
    faults = _fuse_planted_faults(gen)
    for name in ("fuse_swiglu_mlp", "fuse_rms_norm_head"):
        cases[name][0]["planted_faults"] = faults
    torch.cuda.empty_cache()
    for site, recs in _gemm_products(gen).items():
        cases[site][0]["gemm_products"] = recs
    return cases


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    # RMSNorm: a decode step's rows, 4096 rows, a `base` training step's
    # rows over the fp32 weight, and the Engine's prefill forwards (n
    # same-bucket prompts, n in 4/2/1: 2048 and 512 rows among them), these
    # from a generator of their own, so the cases after them keep their
    # inputs
    rows_gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {"rms_norm": [_rms_case(8, 4096, gen, torch.bfloat16),
                          _rms_case(8 * 512, 4096, gen, torch.bfloat16),
                          _rms_case(3 * 2048, 2048, gen, torch.float32),
                          _rms_case(4 * 512, 4096, rows_gen, torch.bfloat16),
                          _rms_case(512, 4096, rows_gen, torch.bfloat16)],
             "decode_attention_dense": [
                 _dense_case(gen, [1, 37, 128, 129, 500, 1024, 2047, 2048]),
                 _dense_case(gen, _serve_lengths(), C=1024, label="serve")],
             "decode_attention_paged": [
                 _paged_case(gen, [0, 1, 128, 129, 256, 300, 777, 1024]),
                 _paged_case(gen, _serve_lengths(), label="serve")]}
    base = _flash_case(gen, 3, 2048, 16, 8, 128)
    longctx = _flash_case(gen, 1, 16384, 16, 8, 128, heads=2)
    cases["flash_attention_fwd"] = [base[0], longctx[0]]
    cases["flash_attention_bwd"] = [base[1], longctx[1]]
    shapes = _base_leaf_shapes()
    cases["adamw"] = [_adamw_case(gen, shapes, "base, all 75 leaves"),
                      _adamw_case(gen, [shapes[5]], "base, gate_up_proj")]
    torch.cuda.empty_cache()
    cases["adamw"].append(_adamw_case(gen, _ssd_train_leaf_shapes(), "ssd_train, all 43 leaves",
                                      in_place=True))
    torch.cuda.empty_cache()
    # `ssd_train`'s shape: G = batch 2 x 64 heads, T 4096, P 64, N 128, L 128;
    # SSDConfig()'s defaults (hidden 4096 over 32 heads: P 128, N 64, L 64;
    # G = batch 2 x 32 heads, T 4096), two column blocks a recurrence;
    # bench.py's on-chip case (G 8, T 512, P 128, N 128, L 128); and
    # ssd_tiny_config's widths
    ssd = [_ssd_case(gen, 128, 4096, 64, 128, 128, full=True),
           _ssd_case(gen, 64, 4096, 128, 64, 64, full=True),
           _ssd_case(gen, 8, 512, 128, 128, 128, full=True),
           _ssd_case(gen, 8, 256, 32, 16, 16, full=True)]
    cases["ssd_scan"] = [fwd for fwd, _ in ssd]
    cases["ssd_scan_bwd"] = [bwd for _, bwd in ssd]
    torch.cuda.empty_cache()
    cases.update(phase_fuse_kernels(gen))
    # the RMSNorm backward: norm-only (the stock backward) at `base`'s,
    # `longctx`'s and `ssd_train`'s rows over their fp32 weights, the
    # fuse_add_rms_norm site's mode (h and d_s) at `base`, fp32 rows at the
    # parity phase's narrow Llama (2 x 256 rows of 256); untimed, a ragged
    # row (33 vectors), one row, and a width past the ring (the wide kernel)
    bf = torch.bfloat16
    cases["rms_norm_bwd"] = [
        _norm_bwd_case(gen, 3 * 2048, 2048, bf, label="base (train)"),
        _norm_bwd_case(gen, 3 * 2048, 2048, bf, site=True, label="base, fuse_add_rms_norm"),
        _norm_bwd_case(gen, 16384, 2048, bf, label="longctx"),
        _norm_bwd_case(gen, SSD_TRAIN_BATCH * SSD_TRAIN_SEQ, 4096, bf, label="ssd_train"),
        _norm_bwd_case(gen, 2 * 256, 256, torch.float32, label="parity, fp32"),
        _norm_bwd_case(gen, 1037, 264, bf, timed=False, label="ragged"),
        _norm_bwd_case(gen, 1037, 264, bf, site=True, timed=False, label="ragged"),
        _norm_bwd_case(gen, 1, 2048, bf, timed=False, label="one row"),
        _norm_bwd_case(gen, 64, 16384, bf, timed=False, label="the wide kernel"),
        _norm_bwd_case(gen, 64, 16384, bf, site=True, timed=False, label="the wide kernel")]
    cases["rms_norm_bwd"][0]["planted_faults"] = _norm_bwd_planted_faults(gen)
    cases["injected_write_race"] = [_injected_case(gen, "write_race")]
    cases["injected_parallel_carry"] = [_injected_case(gen, "parallel_carry")]
    return cases


def _injected_case(gen, kind):
    """A seeded-defect kernel of the gate at the gate's shapes, against its
    plain version (what a correct kernel gives) on the part the defect
    leaves defined, which must be exact (tolerance 0: 2 x and x are exact
    in fp32): every element of write-race's tile 0 is one CTA's doubled
    value (the CTAs race element by element), and its other tiles must keep
    the NaN sentinel; parallel-carry's first tile of each row reads no
    carried state.  The rest is undefined by design."""
    import torch
    from paddle_tpu_torch.analysis.kernel_lint import sentinel_outputs
    from paddle_tpu_torch.kernels import injected

    if kind == "write_race":
        x = torch.randn(32, 128, generator=gen, device="cuda")
        fn, plain = injected.write_race, injected.write_race_reference
    else:
        x = torch.randn(2, 32, 128, generator=gen, device="cuda")
        fn, plain = injected.parallel_carry, injected.parallel_carry_reference
    with sentinel_outputs():
        y = fn(x)
    ref = plain(x)
    torch.cuda.synchronize()
    rec = {"shape": list(x.shape), "tolerance": 0.0}
    if kind == "write_race":
        # each element of tile 0 against the nearest of the four CTAs' values
        errs = (y[:8][None] - ref.reshape(4, 8, 128)).abs().amin(0)
        won = (y[:8][None] == ref.reshape(4, 8, 128)).float().argmax(0)
        rec.update(max_abs_err=float(errs.max()),
                   elements_stored_by_cta=[int((won == t).sum()) for t in range(4)],
                   unwritten_elements=int(torch.isnan(y).sum()),
                   defined="each element of tile 0 is one CTA's 2x; tiles 1-3 keep the "
                           "sentinel")
        check(rec["unwritten_elements"] == y[8:].numel() and not torch.isnan(y[:8]).any(),
              f"injected write_race: {rec['unwritten_elements']} unwritten elements, "
              f"expected {y[8:].numel()}")
    else:
        rec.update(max_abs_err=max_err(y[:, :8], ref[:, :8]),
                   elements_off_the_running_sum=int((y != ref).sum()),
                   defined="the first tile of each row (reads no carried state)")
    check(rec["max_abs_err"] == 0.0,
          f"injected {kind}: the defined part is {rec['max_abs_err']} from the plain version")
    rec["ms"] = time_ms(lambda: fn(x))
    rec["plain_ms"] = time_ms(lambda: plain(x))
    rec["bound_ms"], rec["bound_by"] = bound(2 * x.numel() * 4, x.numel())
    # the plain version is one PyTorch call (2 x; a cumsum over a view of
    # x), so it is also the library call: timed again here as such
    rec["library_ms"] = time_ms(lambda: plain(x))
    log(f"kernels: injected_{kind} {rec}")
    return rec


# ---------------------------------------------------------------------------
# the kernel gate
# ---------------------------------------------------------------------------

# what the card's gate must report for each seeded defect (more may be
# observed: the defective kernels also disagree with their plain versions)
GATE_INJECTIONS = {"write-race": {"krn-write-race", "krn-coverage-hole"},
                   "parallel-carry": {"krn-parallel-carry"},
                   "emit-race": {"krn-coverage-hole"}}


def _gate_runs():
    """The gate's CLI on the card, clean and under each KERNEL_GATE_INJECT,
    four processes started together: ``{inject: (rc, json, stderr)}``."""
    import os

    procs = {}
    for inject in ("", *GATE_INJECTIONS):
        env = dict(os.environ, KERNEL_GATE_INJECT=inject)
        env.pop("FLAGS_kernel_admission", None)
        procs[inject] = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.kernels.registry", "--device", "cuda"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for inject, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        lines = stdout.strip().splitlines()
        check(lines, f"kernel_gate: the CLI (KERNEL_GATE_INJECT={inject!r}) printed nothing; "
                     f"rc {proc.returncode}:\n{stderr[-3000:]}")
        out[inject] = (proc.returncode, json.loads(lines[-1]), stderr)
    return out


def _check_gate(runs):
    """The clean gate and the three seeded defects, as the CLI reported
    them; returns the kernel_gate path's launches of the seeded kernels."""
    from paddle_tpu_torch.kernels import registry

    registry.load_all()
    rc, clean, err = runs[""]
    check(rc == 0 and clean["kernel_count"] == GATE_ENTRIES and clean["total_findings"] == 0,
          f"kernel_gate: clean gate rc {rc}, {clean['kernel_count']} entries, "
          f"{clean['total_findings']} findings:\n{err[-3000:]}")
    for name, k in clean["kernels"].items():
        check(k["legs"] == ["static", "dynamic"], f"kernel_gate: {name} ran legs {k['legs']}")
        check(k["dtypes"] == list(registry.entries()[name].dtypes),
              f"kernel_gate: {name} checked at {k['dtypes']}")
        check(k["smem_bytes_by_kernel"] == k["smem_bytes_card_by_kernel"],
              f"kernel_gate: {name} declares {k['smem_bytes_by_kernel']} B of shared memory, "
              f"the card reports {k['smem_bytes_card_by_kernel']}")
    dyn = {n: round(k["dynamic_ms"], 3) for n, k in clean["kernels"].items()}
    pairs = sum(max(1, len(k["dtypes"])) for k in clean["kernels"].values())
    log(f"kernel_gate: clean, {GATE_ENTRIES} entries at {pairs} (entry, dtype) pairs, both legs; "
        f"dynamic leg ms by entry {dyn} (sum {sum(dyn.values()):.1f} ms)")
    log(f"kernel_gate: compiled attributes "
        f"{ {n: k['attributes_by_kernel'] for n, k in clean['kernels'].items()} }")
    launches = {}
    for inject, want in GATE_INJECTIONS.items():
        rc, rep, err = runs[inject]
        name = "injected_" + inject.replace("-", "_")
        k = rep["kernels"].get(name, {})
        codes = set(k.get("codes", {}))
        check(rc == 1 and want <= codes,
              f"kernel_gate: KERNEL_GATE_INJECT={inject} rc {rc}, codes {k.get('codes')}, "
              f"expected {sorted(want)}:\n{err[-3000:]}")
        others = {n: v["findings"] for n, v in rep["kernels"].items() if n != name}
        check(len(others) == GATE_ENTRIES and not any(others.values()),
              f"kernel_gate: KERNEL_GATE_INJECT={inject}: other entries {others}")
        log(f"kernel_gate: {inject} refused with {k['codes']} (static leg alone: "
            f"{'clean' if inject == 'emit-race' else 'refused'}); gate launches "
            f"{k.get('gate_launches')}")
        launches.update({n: c for n, c in k.get("gate_launches", {}).items()
                         if n.startswith("injected_")})
    return launches


def _admission_drive(cfg, cfg16, seed, device):
    """The narrow Llama of `parity` through the Engine, `generate`, one
    TrainStep step and one step with every fusion site verified and
    activated; then ``cfg16`` (the same widths, bf16 compute over fp32
    params, as `base` trains) through one TrainStep step and one fused
    step.  Each path's launches are counted from 0.  Returns the tokens,
    losses and counts."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import emit, launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(cfg, device=device, seed=seed)
    rng = np.random.default_rng(seed + 1)
    prefix = rng.integers(1, cfg.vocab_size, size=(128,)).astype(np.int32)
    reqs = _requests(rng, cfg.vocab_size, (17, 100, 130, -40), (24, 16, 20, 16), prefix)
    out = {"launches": {}}
    reset_launch_counts()
    _, outs = _serve(model, reqs, device, max_batch=4, num_blocks=32, block_size=128,
                     prefill_buckets=(128, 256), decode_chunk=8)
    out["launches"]["engine"] = launch_counts()
    out["engine"] = [o.output_ids for o in outs]
    reset_launch_counts()
    gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
    out["launches"]["generate"] = launch_counts()
    out["generate"] = gen[0].cpu().tolist()
    ids = np.random.default_rng(seed + 3).integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    step = TrainStep(model, lambda m, x: m.compute_loss(m(x), x),
                     AdamW(learning_rate=3e-4, weight_decay=0.1, parameters=model.parameters()))
    reset_launch_counts()
    out["loss"] = float(step(ids))
    out["launches"]["train"] = launch_counts()
    table = emit.verified_activation(device)
    check(sorted(table) == sorted(emit.SITES), f"kernel_gate: sites verified {sorted(table)}")
    with emit.activate(table):
        reset_launch_counts()
        out["fused_loss"] = float(step(ids))
        out["launches"]["fused_train"] = launch_counts()
    model16 = LlamaForCausalLM(cfg16, device=device, seed=seed)
    step16 = TrainStep(model16, lambda m, x: m.compute_loss(m(x), x),
                       AdamW(learning_rate=3e-4, weight_decay=0.1,
                             parameters=model16.parameters()))
    reset_launch_counts()
    out["loss_bf16"] = float(step16(ids))
    out["launches"]["train_bf16"] = launch_counts()
    with emit.activate(table):
        reset_launch_counts()
        out["fused_loss_bf16"] = float(step16(ids))
        out["launches"]["fused_train_bf16"] = launch_counts()
    return out


# the (entry, dtype) pairs each admission path must admit (once each, on the
# card): the fp32 narrow Llama's, then the bf16 legs' tensor-core flash and
# bf16-rows RMSNorm; verified_activation admits every site at all its dtypes
_FLASH_ENTRIES = ("flash_fwd_resident", "flash_fwd_stream", "flash_bwd_stream")
_SITE_ENTRIES = ("fuse_swiglu_mlp", "fuse_swiglu_mlp_bwd", "fuse_add_rms_norm",
                 "fuse_add_rms_norm_bwd", "fuse_rms_norm_head", "fuse_rms_norm_head_bwd")
ADMITTED_BY_PATH = {
    "engine": {("rms_norm", "float32"), ("paged_decode", "float32"),
               ("paged_decode_fused", "float32")},
    "generate": {("decode_mmha", "float32"), ("decode_mmha_fused", "float32")},
    "train": {(n, "float32") for n in (*_FLASH_ENTRIES, "adamw_fused", "rms_norm_bwd")},
    "fused_train": {(n, dt) for n in _SITE_ENTRIES
                    for dt in ("float32", "bfloat16+float32", "bfloat16",
                               "bfloat16+float32@base")},
    "train_bf16": {(n, "bfloat16") for n in _FLASH_ENTRIES} | {
        ("rms_norm", "bfloat16+float32"), ("rms_norm_bwd", "bfloat16+float32")},
}


def _admission_paths(seed, device="cuda"):
    """`parity`'s narrow Llama driven with FLAGS_kernel_admission off and
    then on (fresh weights from one seed each time): every registered
    kernel on the paths admitted exactly once at the dtype it ran, the
    same tokens, the same losses to the bit, and the same launch counts
    (the dynamic leg's own launches land in no path).  With the flag off
    only verified_activation admits (the sites, as the JAX one does)."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.kernels import registry
    from paddle_tpu_torch.models import llama_tiny_config

    widths = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=512)
    cfg = llama_tiny_config(**widths)
    cfg16 = llama_tiny_config(**widths, dtype="bfloat16", param_dtype="float32")
    flags.set_flags({"kernel_admission": False})
    registry.reset_admission_cache()
    off = _admission_drive(cfg, cfg16, seed, device)
    sites = {(n, device, dt) for n, dt in ADMITTED_BY_PATH["fused_train"]}
    check(set(registry.admissions()) == sites,
          f"kernel_gate: with the flag off admitted {registry.admissions()}, expected the "
          f"sites verified_activation admits, {sorted(sites)}")
    registry.reset_admission_cache()
    t0 = time.perf_counter()
    flags.set_flags({"kernel_admission": True})
    try:
        on = _admission_drive(cfg, cfg16, seed, device)
    finally:
        flags.set_flags({"kernel_admission": False})
    secs = time.perf_counter() - t0
    admitted = registry.admissions()
    spent = registry.admission_seconds()
    want = {(n, device, dt) for path in ADMITTED_BY_PATH.values() for n, dt in path}
    check(set(admitted) == want and set(admitted.values()) == {1},
          f"kernel_gate: admitted {admitted}, expected each of {sorted(want)} once")
    for key in ("engine", "generate"):
        check(on[key] == off[key], f"kernel_gate: {key} tokens differ under admission")
    for key in ("loss", "fused_loss", "loss_bf16", "fused_loss_bf16"):
        check(on[key] == off[key], f"kernel_gate: {key} {on[key]} under admission, "
                                   f"{off[key]} without")
    check(on["launches"] == off["launches"],
          f"kernel_gate: launches under admission {on['launches']}, without {off['launches']}")
    nonzero = {p: {k: n for k, n in c.items() if n} for p, c in off["launches"].items()}
    log(f"kernel_gate: admission on the Engine, generate, TrainStep and fused-step paths "
        f"(fp32, then bf16 steps): {len(admitted)} (entry, dtype) pairs admitted once each; "
        f"tokens and losses ({off['loss']}, {off['fused_loss']}, {off['loss_bf16']}, "
        f"{off['fused_loss_bf16']}) equal to the admission-off run; launches per path "
        f"{nonzero}; admission-on drive {secs:.3f} s, of which admission (both legs) "
        f"{sum(spent.values()) * 1e3:.1f} ms: "
        f"{ {f'{n}@{dt}': round(s * 1e3, 1) for (n, _, dt), s in sorted(spent.items())} }")
    registry.reset_admission_cache()


def _refusal_before_launch():
    """``ssd_scan`` and ``rms_norm`` re-registered with the write-race
    builder: with admission on each wrapper raises KernelRejected naming
    krn-write-race, and its launch counter does not move."""
    import torch
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.kernels import registry, rms_norm, ssd_scan

    calls = {
        "ssd_scan": (ssd_scan.ssd_scan, lambda: ssd_scan.ssd_scan(
            *(torch.randn(2, 128, w, device="cuda") for w in (32, 16, 16)),
            -torch.ones(2, 128, device="cuda"), chunk=16)),
        "rms_norm": (rms_norm.rms_norm, lambda: rms_norm.rms_norm(
            torch.randn(64, 256, device="cuda"), torch.ones(256, device="cuda"))),
    }
    saved = registry.entries()
    flags.set_flags({"kernel_admission": True})
    registry.reset_admission_cache()
    try:
        for name, (wrapper, call) in calls.items():
            registry.register(name, registry._build_injected_write_race)
            before = wrapper.launches
            try:
                call()
                raise PhaseError(f"kernel_gate: sabotaged {name} was not refused")
            except registry.KernelRejected as e:
                check("krn-write-race" in str(e), f"kernel_gate: {name} refused without "
                                                  f"krn-write-race: {e}")
            check(wrapper.launches == before, f"kernel_gate: {name} launched before refusal")
    finally:
        for name in calls:
            e = saved[name]
            registry.register(name, e.build, presets=e.presets, description=e.description,
                              tol=e.tol, dtypes=e.dtypes)
        flags.set_flags({"kernel_admission": False})
        registry.reset_admission_cache()
    log("kernel_gate: sabotaged ssd_scan and rms_norm refused before their first launch")


def _emit_race_bound():
    """The bound of the emit-race variant's work at the gate's example: the
    fuse_swiglu_mlp forward (gate_up, SwiGLU, down) on emit.SITES' example
    shapes, fp32: bytes each operand read once and the output written once,
    operations over the fp32 rate."""
    from paddle_tpu_torch.kernels import emit

    site = emit.SITES["fuse_swiglu_mlp"]
    (x, _), (wgu, _), (wd, _) = site.example_shapes
    (M, H), I = x, site.example_static["intermediate_size"]
    nbytes = 4 * (M * H + wgu[0] * wgu[1] + wd[0] * wd[1] + M * H)
    b_ms, b_by = bound(nbytes, 3 * 2 * M * H * I)
    return {"shape": {"M": M, "H": H, "I": I, "dtype": "float32"}, "bytes": nbytes,
            "flops": 6 * M * H * I, "bound_ms": b_ms, "bound_by": b_by}


def phase_kernel_gate(seed):
    t0 = time.perf_counter()
    emit_race = _emit_race_bound()
    log(f"kernel_gate: emit-race variant's work at the gate's example: {json.dumps(emit_race)}")
    launches = _check_gate(_gate_runs())
    t_cli = time.perf_counter() - t0
    _admission_paths(seed)
    _refusal_before_launch()
    log(f"kernel_gate: {time.perf_counter() - t0:.1f} s (the four CLI runs together "
        f"{t_cli:.1f} s)")
    return {"launches": launches, "emit_race_bound": emit_race}


def _requests(rng, vocab, lengths, new_tokens, prefix=None):
    """Greedy requests with random prompts; a length ``-n`` makes the prompt
    ``prefix`` followed by ``n`` random tokens (a prefix-cache hit)."""
    import numpy as np
    from paddle_tpu_torch.serving import GenRequest

    reqs = []
    for P, n in zip(lengths, new_tokens):
        ids = rng.integers(1, vocab, size=(abs(P),)).astype(np.int32)
        if P < 0:
            ids = np.concatenate([prefix, ids])
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=int(n)))
    return reqs


def _serve(model, reqs, device, hook=None, **engine_kw):
    from paddle_tpu_torch.serving import Engine

    eng = Engine(model, device=device, **engine_kw)
    if hook is not None:
        hook(eng)
    for r in reqs:
        eng.add_request(r)
    outs = {o.request_id: o for o in eng.run_to_completion()}
    return eng, [outs[r.request_id] for r in reqs]


def phase_parity(seed):
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                         load_paddle_tpu_params, to_paddle_tpu_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama_tiny_config(vocab_size=512, hidden_size=256, intermediate_size=512,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, max_position_embeddings=512)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=seed)
    gpu = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, size=(128,)).astype(np.int32)
    lens, news = (17, 100, 130, 250, -40, -90), (24, 16, 20, 12, 16, 8)
    kw = dict(max_batch=4, num_blocks=32, block_size=128, prefill_buckets=(128, 256),
              decode_chunk=8)
    results = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        reqs = _requests(np.random.default_rng(seed + 1), cfg.vocab_size, lens, news, prefix)
        eng, outs = _serve(model, reqs, dev, **kw)
        gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
        gen_tokens = gen[0, len(reqs[0].prompt_ids):].cpu().tolist()
        check(gen_tokens == outs[0].output_ids[:16],
              f"parity: {name} generate and Engine disagree")
        results[name] = ([o.output_ids for o in outs], gen_tokens, eng.stats)
    with torch.no_grad():
        ids = torch.from_numpy(prefix[None].astype(np.int64))
        lg_cpu = cpu(ids)
        lg_gpu = gpu(ids.cuda()).cpu()
    lerr = max_err(lg_gpu, lg_cpu)
    log(f"parity: logits max err card vs cpu {lerr:.3e}; prefix hits "
        f"{results['cuda'][2]['prefix_hit_blocks']}")
    check(lerr < 1e-4, f"parity: fp32 logits differ by {lerr}")
    check(results["cpu"][0] == results["cuda"][0], "parity: Engine tokens differ")
    check(results["cpu"][1] == results["cuda"][1], "parity: generate tokens differ")
    for key in ("prefills", "prefill_tokens", "prefix_hit_blocks"):
        check(results["cpu"][2][key] == results["cuda"][2][key], f"parity: stats {key}")
    _train_parity("llama", cfg, cpu, gpu, seed, {"flash_attention_fwd": cfg.num_hidden_layers})
    with _fusion_scope("parity") as table:
        L = cfg.num_hidden_layers
        check(sorted(table) == sorted(("fuse_swiglu_mlp", "fuse_add_rms_norm",
                                       "fuse_rms_norm_head")),
              f"parity: sites verified on the card: {sorted(table)}")
        _train_parity("llama fused", cfg, cpu, gpu, seed, {
            "flash_attention_fwd": L, "rms_norm": L, "fuse_swiglu_mlp": L,
            "fuse_swiglu_mlp_bwd": L, "fuse_add_rms_norm": L, "fuse_add_rms_norm_bwd": L,
            "fuse_rms_norm_head": 1, "fuse_rms_norm_head_bwd": 1})
    _ssd_parity(seed)


@contextlib.contextmanager
def _fusion_scope(label):
    """Every fusion site that passes ``emit.verify_site`` on the card,
    activated for the scope's CPU and card models alike (each device runs
    its own path: the kernels here, the plain reference on the CPU)."""
    from paddle_tpu_torch.kernels import emit

    verified = emit.verified_activation("cuda")
    log(f"{label}: sites verified on the card: {sorted(verified)}")
    with emit.activate({name: emit.make_fused(name) for name in verified}):
        yield verified


def _ssd_parity(seed):
    """The card against the CPU in fp32 on the tiny pure and hybrid SSD
    stacks: Engine (recurrent and hybrid paths) and generate tokens equal,
    logits within 1e-4, three TrainStep steps as ``_train_parity``."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import (SSDForCausalLM, load_paddle_tpu_params,
                                         ssd_tiny_config, ssd_tiny_hybrid_config,
                                         to_paddle_tpu_params)

    lens, news = (17, 40, 100, 70, 5, 128), (24, 16, 20, 12, 16, 8)
    kw = dict(max_batch=4, num_blocks=64, block_size=16, prefill_buckets=(64, 128),
              decode_chunk=8)
    for label, cfg in (("ssd", ssd_tiny_config()), ("hybrid", ssd_tiny_hybrid_config())):
        cpu = SSDForCausalLM(cfg, device="cpu", seed=seed)
        gpu = SSDForCausalLM(cfg, device="cuda", seed=seed)
        load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
        results = {}
        for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
            reqs = _requests(np.random.default_rng(seed + 1), cfg.vocab_size, lens, news)
            eng, outs = _serve(model, reqs, dev, **kw)
            check(eng.backend.kind == ("recurrent" if label == "ssd" else "hybrid"),
                  f"parity {label}: backend {eng.backend.kind}")
            gen = model.generate(reqs[0].prompt_ids[None], max_new_tokens=16)
            gen_tokens = gen[0, len(reqs[0].prompt_ids):].cpu().tolist()
            check(gen_tokens == outs[0].output_ids[:16],
                  f"parity {label}: {name} generate and Engine disagree")
            results[name] = ([o.output_ids for o in outs], gen_tokens)
        with torch.no_grad():
            ids = torch.from_numpy(np.random.default_rng(seed + 2).integers(
                1, cfg.vocab_size, (2, 200)).astype(np.int64))
            lg_cpu = cpu(ids)
            lg_gpu = gpu(ids.cuda()).cpu()
        lerr = max_err(lg_gpu, lg_cpu)
        log(f"parity {label}: logits max err card vs cpu {lerr:.3e}")
        check(lerr < 1e-4, f"parity {label}: fp32 logits differ by {lerr}")
        check(results["cpu"] == results["cuda"], f"parity {label}: Engine or generate tokens "
              f"differ")
        kinds = cfg.types
        _train_parity(label, cfg, cpu, gpu, seed, {"ssd_scan": kinds.count("ssd"),
                                                   "ssd_scan_bwd": kinds.count("ssd"),
                                                   "flash_attention_fwd": kinds.count("attention")})


def _train_parity(label, cfg, cpu, gpu, seed, per_step, steps=3, lr=3e-4):
    """Training on the card (kernels) against the CPU (plain versions) in
    fp32 from the same weights: step-1 gradients within ``PARITY_GRAD_TOL``
    (sums in another order); after ``steps`` TrainStep steps the losses
    within rtol 1e-5, the m and v slots within ``PARITY_SLOT_TOL`` and the
    parameters within ``PARITY_PARAM_ATOL``.  The card's steps must launch
    each kernel of ``per_step`` that many times a step, and AdamW once a
    leaf."""
    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
    from paddle_tpu_torch.models import (load_paddle_tpu_params, to_paddle_tpu_opt_state,
                                         to_paddle_tpu_params)
    from paddle_tpu_torch.optimizer import AdamW

    def rel_tol(ref, tol):
        return (tol * float(ref.abs().max()), tol)

    load_paddle_tpu_params(gpu, to_paddle_tpu_params(cpu))
    ids = np.random.default_rng(seed + 3).integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
    grads = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        t = torch.from_numpy(ids).to(model.device)
        loss = model.compute_loss(model(t), t)
        grads[name] = dict(zip([n for n, _ in model.named_parameters()],
                               torch.autograd.grad(loss, list(model.parameters()))))
    gerr = 0.0
    for n, g in grads["cuda"].items():
        ref = grads["cpu"][n]
        gerr = max(gerr, max_err(g.cpu(), ref))
        check(within(g.cpu(), ref, rel_tol(ref, PARITY_GRAD_TOL)),
              f"parity {label}: step-1 gradient of {n} differs by {max_err(g.cpu(), ref)}")

    def loss_fn(m, x):
        return m.compute_loss(m(x), x)

    losses, slots = {}, {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        opt = AdamW(learning_rate=lr, weight_decay=0.1, parameters=model.parameters())
        step = TrainStep(model, loss_fn, opt)
        reset_launch_counts()
        losses[name] = [float(step(ids)) for _ in range(steps)]
        slots[name] = to_paddle_tpu_opt_state(step)["slots"]
    counts = launch_counts()
    perr = max(max_err(p.detach().cpu(), q.detach())
               for p, q in zip(gpu.parameters(), cpu.parameters()))
    serr = {"m": 0.0, "v": 0.0}          # largest error as a share of the slot's max |value|
    for n, ref_slots in slots["cpu"].items():
        for s in serr:
            a, b = torch.from_numpy(slots["cuda"][n][s]), torch.from_numpy(ref_slots[s])
            serr[s] = max(serr[s], max_err(a, b) / max(float(b.abs().max()), 1e-30))
            check(within(a, b, rel_tol(b, PARITY_SLOT_TOL)),
                  f"parity {label}: slot {s} of {n} differs by {max_err(a, b)} after {steps} "
                  f"steps")
    log(f"parity {label}: training {steps} steps, losses cpu {losses['cpu']} card {losses['cuda']}; "
        f"step-1 gradient max err {gerr:.3e}; parameter max err {perr:.3e} (limit "
        f"{PARITY_PARAM_ATOL:.1e}); step-{steps} slot max err / max |slot| m {serr['m']:.3e} "
        f"v {serr['v']:.3e}; card launches {counts}")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        check(abs(a - b) <= 1e-5 * abs(b), f"parity {label}: training losses differ: {losses}")
    check(perr <= PARITY_PARAM_ATOL,
          f"parity {label}: parameters differ by {perr} after {steps} steps")
    want = dict(per_step, adamw=len(list(gpu.parameters())))
    check(all(counts[k] == steps * n for k, n in want.items()),
          f"parity {label}: the card's training steps launched {counts}, expected {want} a step")
    check(counts["rms_norm"] > 0 and counts["rms_norm_bwd"] == counts["rms_norm"],
          f"parity {label}: {counts['rms_norm_bwd']} RMSNorm backward launches for "
          f"{counts['rms_norm']} forwards (one each, nothing recomputed)")


def _drive_train(step_fn, ids, steps):
    """Set every launch count to 0, run ``steps`` training steps on ``ids``,
    and read the counts just after.  Launches inside the optimizer's update
    are tallied apart from the rest of each step.  Returns the losses, the
    wall time of each step (host clock, ending in a synchronise) and the
    record of counts."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    update = step_fn._update_fn
    in_update = dict.fromkeys(launch_counts(), 0)

    def counted_update(*a, **kw):
        before = launch_counts()
        out = update(*a, **kw)
        for name, n in launch_counts().items():
            in_update[name] += n - before[name]
        return out

    step_fn._update_fn = counted_update
    losses, walls, per_step = [], [], []
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        for _ in range(steps):
            before = launch_counts()
            t0 = time.perf_counter()
            losses.append(float(step_fn(ids)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            per_step.append({n: c - before[n] for n, c in launch_counts().items()})
        counts = launch_counts()
    finally:
        step_fn._update_fn = update
    return losses, walls, {"launches": counts, "launches_in_update": in_update,
                           "launches_per_step": per_step}


def _train_leg(label, fused, fp32_loss=False, preset="base", steps=TRAIN_STEPS):
    """One fresh pretrain step of ``preset`` (seed 0: the same weights and
    batch every time), ``steps`` steps through ``_drive_train``; with
    ``fused`` inside ``emit.activate(emit.verified_activation("cuda"))``,
    where every seam reads the table at each call.  Checks every step's
    launches (inside and outside the optimizer update; a recomputed layer
    runs its forward's kernels twice) and that losses are finite and
    falling.  With ``fp32_loss`` the record also holds step 1's loss with
    fp32 activations (stock, before any update).  Returns the record and
    ``(step_fn, ids)``."""
    import math

    import torch
    from paddle_tpu_torch.kernels import emit, launch_counts
    from paddle_tpu_torch.models.presets import build_pretrain_step, model_flops_per_token

    t0 = time.perf_counter()
    step_fn, ids, model, cfg, (B, S, _) = build_pretrain_step(preset, "cuda")
    torch.cuda.synchronize()
    log(f"{label}: {preset} preset, {cfg.num_hidden_layers} layers, "
        f"{sum(p.numel() for p in model.parameters())} params (dtype {cfg.dtype}, params "
        f"{cfg.pdtype}), batch {B} x seq {S}, built in {time.perf_counter() - t0:.1f} s")
    L, n_leaves = cfg.num_hidden_layers, len(list(model.parameters()))
    passes = 2 if cfg.recompute else 1       # a layer's forward, again in the backward
    want = dict.fromkeys(launch_counts(), 0)
    want.update(flash_attention_fwd=passes * L, flash_attention_bwd=L, adamw=n_leaves)
    scope = contextlib.nullcontext({})
    if fused:
        table = emit.verified_activation("cuda")
        check(sorted(table) == sorted(emit.SITES),
              f"{label}: sites verified on the card: {sorted(table)}")
        scope = emit.activate(table)
        want.update(rms_norm=L, rms_norm_bwd=L, fuse_swiglu_mlp=L, fuse_swiglu_mlp_bwd=L,
                    fuse_add_rms_norm=L, fuse_add_rms_norm_bwd=L, fuse_rms_norm_head=1,
                    fuse_rms_norm_head_bwd=1)
    else:
        # a recomputed layer's norms run forward twice, backward once
        want.update(rms_norm=2 * passes * L + 1, rms_norm_bwd=2 * L + 1)
    want_update = dict.fromkeys(launch_counts(), 0)
    want_update["adamw"] = steps * n_leaves
    loss32 = None
    if fp32_loss:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.no_grad():
            saved, cfg.dtype = cfg.dtype, "float32"
            try:
                loss32 = float(model.compute_loss(model(ids), ids))
            finally:
                cfg.dtype = saved
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with scope:
        losses, walls, rec = _drive_train(step_fn, ids, steps)
    check(all(emit.active(n) is None for n in emit.SITES), f"{label}: the scope leaked")
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (steps - 1)      # step 1 includes the warm-up
    flops = model_flops_per_token(cfg, S) * B * S
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady, loss_fp32=loss32,
               tokens_per_s=B * S / steady * 1e3,
               mfu=flops / (steady / 1e3) / BF16_FLOPS_PER_S,
               peak_bytes=torch.cuda.max_memory_allocated())
    log(f"{label}: losses {losses}; step ms {step_ms}; steady {steady:.3f} ms = "
        f"{rec['tokens_per_s']:.1f} tokens/s, MFU {rec['mfu']:.4f} ({flops / 1e12:.2f} TFLOP a "
        f"step at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s); peak memory "
        f"{rec['peak_bytes'] / 2**30:.2f} GiB")
    log(f"{label}: launches {json.dumps(rec)}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"{label}: step {i + 1} launched {got}, expected {want}")
    check(rec["launches_in_update"] == want_update,
          f"{label}: launches inside the optimizer update {rec['launches_in_update']}, "
          f"expected {want_update}")
    return rec, (step_fn, ids)


def phase_train(profile):
    """`base` pretraining at full width and depth through the port's
    entry points, ``TRAIN_STEPS`` steps (the stock leg); see the module
    docstring."""
    import torch

    rec, (step_fn, ids) = _train_leg("train", False, fp32_loss=True)
    losses, loss32 = rec["losses"], rec["loss_fp32"]
    log(f"train: fp32-activation loss at step 1's weights {loss32} "
        f"(|bf16 - fp32| {abs(losses[0] - loss32):.6g}, limit {TRAIN_LOSS_TOL})")
    check(abs(losses[0] - loss32) <= TRAIN_LOSS_TOL,
          f"train: step 1's bf16 loss {losses[0]} is {abs(losses[0] - loss32)} from the "
          f"fp32-activation loss {loss32}, past {TRAIN_LOSS_TOL}")
    if profile:
        _profile(lambda: step_fn(ids), "train: one base step")
    del step_fn
    torch.cuda.empty_cache()
    return rec


def phase_longctx_train(profile):
    """`longctx` pretraining (the `base` model at seq 16384, batch 1, every
    layer recomputed) through the port's entry points, ``LONGCTX_STEPS``
    steps; see the module docstring."""
    import torch

    rec, (step_fn, ids) = _train_leg("longctx_train", False, preset="longctx",
                                     steps=LONGCTX_STEPS)
    if profile:
        _profile(lambda: step_fn(ids), "longctx_train: one longctx step")
    del step_fn
    torch.cuda.empty_cache()
    return rec


def phase_fuse_train(profile, stock=None):
    """`base` through TrainStep in three legs, stock -> fused -> stock (the
    port's counterpart of bench.py's ``_bench_fuse``); ``stock``, the record
    of the `train` phase run just before, is the first stock leg when
    given.  See the module docstring."""
    import torch
    from paddle_tpu_torch.kernels import emit

    legs = {} if stock is None else {"stock": stock}
    for label, fused in (("stock", False), ("fused", True), ("stock again", False)):
        if label in legs:
            continue
        legs[label], (step_fn, ids) = _train_leg(f"fuse_train {label} leg", fused,
                                                 fp32_loss=label == "stock")
        if fused and profile:
            with emit.activate(emit.verified_activation("cuda")):
                _profile(lambda: step_fn(ids), "fuse_train: one fused base step")
        del step_fn
        torch.cuda.empty_cache()
    stock, fused, again = (legs[k]["losses"] for k in ("stock", "fused", "stock again"))
    loss32 = legs["stock"]["loss_fp32"]
    d_fused, d_fp32 = abs(fused[0] - stock[0]), abs(stock[0] - loss32)
    log(f"fuse_train: step-1 loss fused {fused[0]} stock {stock[0]}: |fused - stock| "
        f"{d_fused:.6g} (limit {TRAIN_LOSS_TOL}); stock's own |bf16 - fp32 activations| "
        f"{d_fp32:.6g} (fp32 loss {loss32}); stock legs' losses {stock} and {again}")
    check(d_fused <= TRAIN_LOSS_TOL,
          f"fuse_train: step 1's fused loss {fused[0]} is {d_fused} from the stock {stock[0]}, "
          f"past {TRAIN_LOSS_TOL}")
    check(again[0] == stock[0] and all(abs(a - b) <= STOCK_LEGS_RTOL * abs(b)
                                       for a, b in zip(again, stock)),
          f"fuse_train: the stock legs disagree: {stock} and {again}")
    rec = dict(legs["fused"])
    rec.update(stock=legs["stock"], stock_again=legs["stock again"], loss_fp32=loss32,
               step1_fused_minus_stock=fused[0] - stock[0])
    return rec


def _profile(fn, label, ranges=()):
    """torch.profiler over one call of ``fn``: device kernel time by name,
    the device's busy share of the wall time, and the device time of the
    kernels launched inside each ``record_function`` range named in
    ``ranges`` (prints, checks nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a record_function range also shows as a device row spanning its
    # kernels: it is read apart below, never summed with them
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and ev.key not in ranges]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile: {label}: wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    # first match wins: the fusion sites' kernels before cuBLAS and RMSNorm,
    # the stock RMSNorm's backward (rms_norm_bwd_*) before its forward
    groups = {"fusion sites": ("gemm_kernel<", "gemm_tc_kernel<", "prep_kernel<",
                               "row_rms_kernel", "add_rms_norm_", "dw_reduce_kernel"),
              "rms_norm_bwd": ("rms_norm_bwd_",),
              "flash": ("flash_",), "gemm (cuBLAS)": ("nvjet", "gemm", "cutlass"),
              "adamw": ("adamw_",), "rms_norm": ("rms_norm_",), "decode": ("decode_",),
              "ssd_scan": ("chunk_state_kernel<true>", "state_pass_kernel<false>",
                           "chunk_apply_kernel<false>"),
              "ssd_scan_bwd": ("chunk_state_kernel<false>", "state_pass_kernel<true>",
                               "chunk_apply_kernel<true>", "ssd_dcb_kernel")}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for ms, _, key in rows:
        name = next((g for g, marks in groups.items() if any(m in key for m in marks)), "other")
        by_group[name] += ms
    log(f"profile: {label}: device ms by group {json.dumps(by_group)}")
    if ranges:
        span = {ev.key: ev.self_device_time_total / 1e3
                for ev in prof.key_averages() if ev.key in ranges}
        log(f"profile: {label}: device span of each range (first kernel to last, gaps "
            f"included) ms {json.dumps(span)}")
    for ms, count, key in rows[:15]:
        log(f"profile:   {ms:10.3f} ms {count:7d}x  {key[:100]}")
    return wall_ms, rows


def _drive_path(model, drive):
    """Set every launch count to 0, run ``drive()``, and read the counts just
    after it.  Each forward of ``model.decoder`` is also tallied by its role:
    one token a row is a decode step, more is a prefill.  Returns
    ``(drive's result, record)``; the record holds the path's counts, its
    decode steps and prefill forwards, and the launches each of them made."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    roles = {r: {"forwards": 0, "launches": dict.fromkeys(launch_counts(), 0)}
             for r in ("decode", "prefill")}
    fwd = model.decoder.forward

    def counted(input_ids, *a, **kw):
        before = launch_counts()
        out = fwd(input_ids, *a, **kw)
        role = roles["decode" if input_ids.shape[1] == 1 else "prefill"]
        role["forwards"] += 1
        for name, n in launch_counts().items():
            role["launches"][name] += n - before[name]
        return out

    model.decoder.forward = counted
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        result = drive()
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        del model.decoder.forward
    rec = {"launches": counts}
    for r, v in roles.items():
        rec[f"{r}_forwards"] = v["forwards"]
        rec[f"launches_per_{r}_forward"] = {
            name: n / v["forwards"] if v["forwards"] else None
            for name, n in v["launches"].items()}
    outside = {name: counts[name] - sum(v["launches"][name] for v in roles.values())
               for name in counts}
    check(not any(outside.values()), f"serve: launches outside the model: {outside}")
    return result, rec


def _check_path(name, rec, norms, decode_kernel=None, n_decode=0):
    """Every decode step of the path launches RMSNorm ``norms`` times and
    ``decode_kernel`` ``n_decode`` times, and no other kernel; every prefill
    forward launches RMSNorm alike and no other kernel."""
    from paddle_tpu_torch.kernels import launch_counts

    check(rec["decode_forwards"] > 0, f"serve: {name} ran no decode step")
    want = dict.fromkeys(launch_counts(), 0)
    want["rms_norm"] = norms
    if decode_kernel is not None:
        want[decode_kernel] = n_decode
    got = rec["launches_per_decode_forward"]
    check(got == want, f"serve: {name} launches a decode step {got}, expected {want}")
    if rec["prefill_forwards"]:
        if decode_kernel is not None:
            want[decode_kernel] = 0
        got = rec["launches_per_prefill_forward"]
        check(got == want, f"serve: {name} launches a prefill forward {got}, expected {want}")


def _serve_requests(vocab, seed):
    """`serve`'s requests: 14 with 128-512-token prompts and two that share
    a 256-token prefix, 32-128 new tokens each; and the chunked-prefill
    request."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=(256,)).astype(np.int32)
    lens = [int(x) for x in rng.integers(128, 513, size=14)] + [-100, -150]
    news = [int(x) for x in rng.integers(32, 129, size=16)]
    reqs = _requests(rng, vocab, lens, news, prefix)
    return reqs, _requests(rng, vocab, [400], [48])


def phase_serve(seed, layers):
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config

    cfg = llama3_8b_config(num_hidden_layers=layers)
    if layers != 32:
        log(f"serve: depth cut to {layers} of 32 layers (widths unchanged)")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"serve: random bf16 weights ({sum(p.numel() for p in model.parameters()) / 1e9:.2f} "
        f"B params) in {time.perf_counter() - t0:.1f} s")
    watch = _HeadWatch(model)
    reqs, chunk_req = _serve_requests(cfg.vocab_size, seed)
    gen_reqs = reqs[:2]
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    from paddle_tpu_torch.serving import Engine

    Engine(model, device="cuda", num_blocks=16, **kw).warmup()

    eng_first = {}
    paths = {}
    t0 = time.perf_counter()
    (eng, outs), paths["engine"] = _drive_path(model, lambda: _serve(
        model, reqs, "cuda", hook=_keep_first_logits(watch, gen_reqs, eng_first),
        num_blocks=512, **kw))
    wall = time.perf_counter() - t0
    (ceng, couts), paths["engine_chunked"] = _drive_path(model, lambda: _serve(
        model, chunk_req, "cuda", num_blocks=64, prefill_chunk=128, **kw))
    gens, paths["generate"] = _drive_path(model, lambda: [
        model.generate(r.prompt_ids[None], max_new_tokens=16) for r in gen_reqs])
    gen_tokens = sum(len(o.output_ids) for o in outs)
    log(f"serve: {len(outs)} requests, {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.1f} generated tok/s (prefill included)")
    log(f"serve: stats {json.dumps(eng.stats)}")
    log(f"serve: chunked-prefill engine stats {json.dumps(ceng.stats)}")
    for name, rec in paths.items():
        log(f"serve: path {name}: {json.dumps(rec)}")
    for r, o in zip(reqs + chunk_req, outs + couts):
        check(len(o.output_ids) == r.max_new_tokens,
              f"serve: {o.request_id} gave {len(o.output_ids)} of {r.max_new_tokens} tokens")
    check(eng.stats["prefix_hit_blocks"] > 0, "serve: the shared prefix never hit")
    check(ceng.stats["chunk_prefills"] > 1, "serve: chunked prefill did not chunk")
    check(paths["engine"]["decode_forwards"] == eng.stats["decode_steps"],
          "serve: Engine decode steps and decode forwards differ")
    for r, g in zip(gen_reqs, gens):
        check(tuple(g.shape) == (1, len(r.prompt_ids) + 16), "serve: generate shape")
    check(not bool(watch.nan), "serve: NaN logits")
    norms = 2 * layers + 1
    _check_path("engine", paths["engine"], norms, "decode_attention_paged", layers)
    _check_path("engine_chunked", paths["engine_chunked"], norms, "decode_attention_paged", layers)
    _check_path("generate", paths["generate"], norms, "decode_attention_dense", layers)
    _first_token_check("serve", model, watch.head, gen_reqs, gens, outs, eng_first)
    watch.restore()
    return paths, model


class _HeadWatch:
    """Stands in for ``model.head``: a device-side NaN flag over every vocab
    projection (no sync) and, while ``sink`` is a list, each projection kept
    there."""

    def __init__(self, model):
        import torch

        self.model, self.head = model, model.head
        self.nan = torch.zeros((), dtype=torch.bool, device="cuda")
        self.sink = None
        model.head = self

    def __call__(self, hidden):
        import torch

        out = self.head(hidden)
        self.nan.logical_or_(torch.isnan(out).any())
        if self.sink is not None:
            self.sink.append(out)
        return out

    def restore(self):
        del self.model.head


def _keep_first_logits(watch, gen_reqs, eng_first):
    """An Engine hook that keeps the first-token logits of ``gen_reqs`` from
    the Engine's prefill (one projected row per request of the group, in
    group order) in ``eng_first``."""
    def hook(eng):
        name = "_run_ssd_prefill" if eng._recurrent else "_run_prefill"
        run = getattr(eng, name)

        def run_prefill(group, Pb, fidx0):
            watch.sink = []
            run(group, Pb, fidx0)
            (lg,), watch.sink = watch.sink, None
            for j, e in enumerate(group):
                for i, r in enumerate(gen_reqs):
                    if e[1] is r:
                        eng_first[i] = lg[j].float()

        setattr(eng, name, run_prefill)

    return hook


def _first_token_check(label, model, head, gen_reqs, gens, outs, eng_first):
    """generate against the Engine on the first token: generate's prefill
    (B=1, exact length) rebuilt as it runs, in bf16 and with fp32
    activations (the config's own mixed-precision mode: bf16 params, fp32
    compute), against the Engine's captured row (bucket-padded prefill).
    Both must lie within ``LOGIT_TOL`` x generate's own bf16 error."""
    import torch

    cfg = model.config
    check(sorted(eng_first) == list(range(len(gen_reqs))),
          f"{label}: Engine first-token logits not captured")
    torch.backends.cuda.matmul.allow_tf32 = False

    def first_logits(prompt, dtype):
        ids = torch.from_numpy(prompt[None]).to("cuda", torch.int32)
        cache = model.init_cache(1, len(prompt) + 16, dtype=dtype)
        hidden, _ = model.decoder(ids, cache=cache)
        return head(hidden[:, -1]).float()[0]

    diverge = []
    with torch.no_grad():
        for i, (r, g, o) in enumerate(zip(gen_reqs, gens, outs)):
            P = len(r.prompt_ids)
            ref = first_logits(r.prompt_ids, "bfloat16")
            saved = cfg.param_dtype, cfg.dtype
            cfg.param_dtype, cfg.dtype = cfg.pdtype, "float32"
            try:
                exact = first_logits(r.prompt_ids, "float32")
            finally:
                cfg.param_dtype, cfg.dtype = saved
            lg = eng_first[i]
            diff = float((lg - ref).abs().max())
            err_gen = float((ref - exact).abs().max())
            err_eng = float((lg - exact).abs().max())
            gap = ref.topk(2).values
            log(f"{label}: prompt {i} (P={P}) first-token logits: max |generate - Engine| "
                f"{diff:.6g}; max |bf16 - fp32 activations| generate {err_gen:.6g}, "
                f"Engine {err_eng:.6g} (limit {LOGIT_TOL} x generate's); max |logit| "
                f"{float(ref.abs().max()):.6g}; generate's top-1 - top-2 gap "
                f"{float(gap[0] - gap[1]):.6g}; first token generate {int(ref.argmax())} "
                f"Engine {int(lg.argmax())} fp32 {int(exact.argmax())}")
            check(int(ref.argmax()) == int(g[0, P]), f"{label}: prompt {i}: rebuilt "
                  "prefill disagrees with generate's first token")
            check(int(lg.argmax()) == o.output_ids[0], f"{label}: prompt {i}: captured "
                  "logits disagree with the Engine's first token")
            check(diff <= LOGIT_TOL * err_gen and err_eng <= LOGIT_TOL * err_gen,
                  f"{label}: prompt {i}: the Engine's first-token logits are {diff} from "
                  f"generate's and {err_eng} from fp32, past {LOGIT_TOL} x generate's "
                  f"own bf16 error {err_gen}")
            toks = g[0, P:].tolist()
            diverge.append(next((j for j, (a, b) in enumerate(zip(toks, o.output_ids))
                                 if a != b), None))
    log(f"{label}: first position where generate's and the Engine's 16 tokens differ, "
        f"per prompt: {diverge} (None = all equal)")


def _ssd_serve_requests(vocab, seed):
    """`ssd_serve`'s 16 requests (128-512-token prompts, 32-128 new tokens)
    and the generator that drew them, for the profile's requests after."""
    import numpy as np

    rng = np.random.default_rng(seed + 5)
    lens = [int(x) for x in rng.integers(128, 513, size=16)]
    news = [int(x) for x in rng.integers(32, 129, size=16)]
    return _requests(rng, vocab, lens, news), rng


def phase_ssd_serve(seed, profile):
    """ssd_8b_config at full depth through the Engine's recurrent path and
    generate; see the module docstring."""
    import torch
    from paddle_tpu_torch.models import SSDForCausalLM, ssd_8b_config
    from paddle_tpu_torch.serving import Engine, RecurrentState

    cfg = ssd_8b_config()
    t0 = time.perf_counter()
    model = SSDForCausalLM(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"ssd_serve: {cfg.num_hidden_layers} layers, random bf16 weights "
        f"({sum(p.numel() for p in model.parameters())} params) in "
        f"{time.perf_counter() - t0:.1f} s")
    watch = _HeadWatch(model)
    reqs, rng = _ssd_serve_requests(cfg.vocab_size, seed)
    gen_reqs = reqs[:2]
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    Engine(model, device="cuda", num_blocks=16, **kw).warmup()
    eng_first = {}
    paths = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (eng, outs), paths["ssd_engine"] = _drive_path(model, lambda: _serve(
        model, reqs, "cuda", hook=_keep_first_logits(watch, gen_reqs, eng_first),
        num_blocks=16, **kw))
    wall = time.perf_counter() - t0
    gens, paths["ssd_generate"] = _drive_path(model, lambda: [
        model.generate(r.prompt_ids[None], max_new_tokens=16) for r in gen_reqs])
    gen_tokens = sum(len(o.output_ids) for o in outs)
    plan = eng.memory_plan()
    log(f"ssd_serve: {len(outs)} requests, {gen_tokens} tokens in {wall:.3f} s = "
        f"{gen_tokens / wall:.1f} generated tok/s (prefill included); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; slot state "
        f"{plan['state_bytes'] / 1e9:.3f} GB for {eng.max_batch} slots")
    log(f"ssd_serve: stats {json.dumps(eng.stats)}")
    for name, rec in paths.items():
        log(f"ssd_serve: path {name}: {json.dumps(rec)}")
    check(isinstance(eng.backend, RecurrentState) and not eng.prefix_cache,
          f"ssd_serve: backend {eng.backend.kind}, prefix cache {eng.prefix_cache}")
    check(eng._rstate._live == {} and eng._pages._ref == {}, "ssd_serve: ledgers not clean")
    for r, o in zip(reqs, outs):
        check(len(o.output_ids) == r.max_new_tokens,
              f"ssd_serve: {o.request_id} gave {len(o.output_ids)} of {r.max_new_tokens} tokens")
    check(paths["ssd_engine"]["decode_forwards"] == eng.stats["decode_steps"],
          "ssd_serve: Engine decode steps and decode forwards differ")
    for r, g in zip(gen_reqs, gens):
        check(tuple(g.shape) == (1, len(r.prompt_ids) + 16), "ssd_serve: generate shape")
    check(not bool(watch.nan), "ssd_serve: NaN logits")
    norms = cfg.num_hidden_layers + 1
    _check_path("ssd_engine", paths["ssd_engine"], norms)
    _check_path("ssd_generate", paths["ssd_generate"], norms)
    _first_token_check("ssd_serve", model, watch.head, gen_reqs, gens, outs, eng_first)
    watch.restore()
    if profile:
        small = _requests(rng, cfg.vocab_size, [128] * 8, [16] * 8)
        engines = []
        wall_ms, _ = _profile(lambda: engines.append(_serve(model, small, "cuda",
                                                            num_blocks=16, **kw)[0]),
                              "ssd_serve: one Engine drain")
        log(f"profile: ssd_serve: {engines[0].stats['decode_steps']} decode steps, "
            f"{wall_ms / engines[0].stats['decode_steps']:.3f} ms wall a step incl. prefill")
    del model, eng
    torch.cuda.empty_cache()
    return paths


def ssd_flops_per_token(cfg, seq_len):
    """Training FLOPs a token of an SSD stack: 6 x matmul params (in_proj,
    out_proj, lm_head) plus the chunked scan, 3 x its forward (a chunk of L
    tokens costs 2 L^2 N + 2 L^2 P + 4 L N P a head)."""
    nh, P, N, L = cfg.num_heads, cfg.head_dim, cfg.state_size, cfg.chunk_size
    H, V, n = cfg.hidden_size, cfg.vocab_size, cfg.num_hidden_layers
    per_layer = H * (2 * nh * P + 2 * nh * N + nh) + nh * P * H
    scan = nh * (2 * L * N + 2 * L * P + 4 * N * P)
    return 6.0 * (n * per_layer + H * V) + 3.0 * n * scan


def phase_ssd_train(profile):
    """ssd_8b widths at SSD_TRAIN_LAYERS layers through the port's
    TrainStep, ``TRAIN_STEPS`` steps; see the module docstring."""
    import math

    import numpy as np
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models import SSDForCausalLM, ssd_8b_config
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = ssd_8b_config(num_hidden_layers=SSD_TRAIN_LAYERS, param_dtype="float32")
    B, S = SSD_TRAIN_BATCH, SSD_TRAIN_SEQ
    model = SSDForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=3e-4, weight_decay=0.1, parameters=model.parameters())
    step_fn = TrainStep(model, lambda m, ids: m.compute_loss(m(ids), ids), opt)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).cuda()
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"ssd_train: ssd_8b widths, {cfg.num_hidden_layers} of 32 layers, {n_params} params "
        f"(dtype {cfg.dtype}, params {cfg.pdtype}), batch {B} x seq {S}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        cfg.dtype = "float32"
        try:
            loss32 = float(model.compute_loss(model(ids), ids))
        finally:
            cfg.dtype = "bfloat16"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _drive_train(step_fn, ids, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    n_leaves = len(list(model.parameters()))
    want = dict.fromkeys(launch_counts(), 0)
    want.update(rms_norm=L + 1, rms_norm_bwd=L + 1, ssd_scan=L, ssd_scan_bwd=L,
                adamw=n_leaves)
    want_update = dict.fromkeys(launch_counts(), 0)
    want_update["adamw"] = TRAIN_STEPS * n_leaves
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    flops = ssd_flops_per_token(cfg, S) * B * S
    log(f"ssd_train: losses {losses}; fp32-activation loss at step 1's weights {loss32} "
        f"(|bf16 - fp32| {abs(losses[0] - loss32):.6g}, limit {TRAIN_LOSS_TOL})")
    log(f"ssd_train: step ms {step_ms}; steady {steady:.3f} ms = {B * S / steady * 1e3:.1f} "
        f"tokens/s, MFU {flops / (steady / 1e3) / BF16_FLOPS_PER_S:.4f} "
        f"({flops / 1e12:.2f} TFLOP a step at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s); "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"ssd_train: launches {json.dumps(rec)}")
    check(all(math.isfinite(x) for x in losses), f"ssd_train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"ssd_train: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"ssd_train: step {i + 1} launched {got}, expected {want}")
    check(rec["launches_in_update"] == want_update,
          f"ssd_train: launches inside the optimizer update {rec['launches_in_update']}, "
          f"expected {want_update}")
    check(abs(losses[0] - loss32) <= TRAIN_LOSS_TOL,
          f"ssd_train: step 1's bf16 loss {losses[0]} is {abs(losses[0] - loss32)} from the "
          f"fp32-activation loss {loss32}, past {TRAIN_LOSS_TOL}")
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady, loss_fp32=loss32,
               peak_bytes=peak)
    if profile:
        _profile_ssd_step(model, lambda: step_fn(ids))
    del step_fn, model, opt
    torch.cuda.empty_cache()
    return rec


def _profile_ssd_step(model, step):
    """One ssd_train step under torch.profiler, with the device time of two
    ranges read apart: the scan's backward kernels and the 128256-wide
    cross-entropy's forward (prints, checks nothing)."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    backward = ts._SSDScan.backward
    loss = model.compute_loss

    def timed_backward(ctx, dy, ds):
        with torch.profiler.record_function("ssd_scan backward (kernels)"):
            return backward(ctx, dy, ds)

    def timed_loss(*a, **kw):
        with torch.profiler.record_function("compute_loss forward"):
            return loss(*a, **kw)

    ts._SSDScan.backward = staticmethod(timed_backward)
    model.compute_loss = timed_loss
    try:
        _profile(step, "ssd_train: one step",
                 ranges=("ssd_scan backward (kernels)", "compute_loss forward"))
    finally:
        ts._SSDScan.backward = staticmethod(backward)
        del model.compute_loss


def phase_profile(model, seed):
    """torch.profiler over one decode-dominated Engine drain at 8B widths
    (8 requests of 128 prompt tokens, 32 new tokens each): device kernel
    time by kernel name, and the device's busy share of the wall time."""
    import numpy as np

    rng = np.random.default_rng(seed + 2)
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512), num_blocks=64)
    _serve(model, _requests(rng, model.config.vocab_size, [128] * 8, [32] * 8), "cuda", **kw)
    reqs = _requests(rng, model.config.vocab_size, [128] * 8, [32] * 8)
    engines = []
    wall_ms, _ = _profile(lambda: engines.append(_serve(model, reqs, "cuda", **kw)[0]),
                          "serve: one Engine drain")
    eng = engines[0]
    steps = eng.stats["decode_steps"]
    log(f"profile: {eng.stats['prefills']} prefills, {steps} decode steps "
        f"({wall_ms / steps:.3f} ms wall a step incl. prefill)")


SOURCES = {
    "rms_norm": ("paddle_tpu_torch/kernels/csrc/rms_norm.cu",
                 "paddle_tpu/kernels/rms_norm.py:38"),
    # _rms_bwd_rule, XLA in the JAX package (no pallas_call)
    "rms_norm_bwd": ("paddle_tpu_torch/kernels/csrc/add_rms_norm.cu",
                     "paddle_tpu/kernels/rms_norm.py:77"),
    "decode_attention_dense": ("paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                               "paddle_tpu/kernels/decode_attention.py:194"),
    "decode_attention_paged": ("paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                               "paddle_tpu/kernels/decode_attention.py:490"),
    "flash_attention_fwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:210"),
    "flash_attention_bwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:447"),
    "adamw": ("paddle_tpu_torch/kernels/csrc/adamw.cu", "paddle_tpu/kernels/adamw.py:79"),
    "ssd_scan": ("paddle_tpu_torch/kernels/csrc/ssd_scan.cu",
                 "paddle_tpu/kernels/ssd_scan.py:159"),
    "ssd_scan_bwd": ("paddle_tpu_torch/kernels/csrc/ssd_scan_bwd.cu",
                     "paddle_tpu/kernels/ssd_scan.py:226"),
    "fuse_swiglu_mlp": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                        "paddle_tpu/kernels/emit.py:111"),
    "fuse_swiglu_mlp_bwd": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                            "paddle_tpu/kernels/emit.py:165"),
    "fuse_add_rms_norm": ("paddle_tpu_torch/kernels/csrc/add_rms_norm.cu",
                          "paddle_tpu/kernels/emit.py:111"),
    "fuse_add_rms_norm_bwd": ("paddle_tpu_torch/kernels/csrc/add_rms_norm.cu",
                              "paddle_tpu/kernels/emit.py:165"),
    "fuse_rms_norm_head": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                           "paddle_tpu/kernels/emit.py:111"),
    "fuse_rms_norm_head_bwd": ("paddle_tpu_torch/kernels/csrc/fused_gemm.cu",
                               "paddle_tpu/kernels/emit.py:165"),
    "injected_write_race": ("paddle_tpu_torch/kernels/csrc/injected.cu",
                            "paddle_tpu/kernels/registry.py:152"),
    "injected_parallel_carry": ("paddle_tpu_torch/kernels/csrc/injected.cu",
                                "paddle_tpu/kernels/registry.py:176"),
}
# a site's launches that live in a second source
ALSO_SOURCE = {"fuse_rms_norm_head_bwd": "paddle_tpu_torch/kernels/csrc/add_rms_norm.cu"}
ALSO_REPLACES = {
    "decode_attention_dense": "paddle_tpu/kernels/decode_attention.py:87",
    "decode_attention_paged": "paddle_tpu/kernels/decode_attention.py:389",
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:115",
    "flash_attention_bwd": "paddle_tpu/kernels/flash_attention.py:290",
}


# the path whose run ``launches`` reports for each kernel
MAIN_PATH = {"rms_norm": "engine", "rms_norm_bwd": "train",
             "decode_attention_dense": "generate", "decode_attention_paged": "engine",
             "flash_attention_fwd": "train", "flash_attention_bwd": "train", "adamw": "train",
             "ssd_scan": "ssd_train", "ssd_scan_bwd": "ssd_train",
             **{name: "fuse_train" for name in ("fuse_swiglu_mlp", "fuse_swiglu_mlp_bwd",
                                                "fuse_add_rms_norm", "fuse_add_rms_norm_bwd",
                                                "fuse_rms_norm_head", "fuse_rms_norm_head_bwd")},
             "injected_write_race": "kernel_gate", "injected_parallel_carry": "kernel_gate"}


def kernel_table(cases, paths):
    out = []
    for name, recs in cases.items():
        main = recs[0]
        src, rep = SOURCES[name]
        by_path = {p: rec["launches"].get(name, 0) for p, rec in paths.items()}
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": by_path.get(MAIN_PATH[name]),
                 "launches_by_path": by_path,
                 # decode paths carry per-forward counts, training paths per-step ones
                 "launches_per_decode_step": {
                     p: rec["launches_per_decode_forward"].get(name, 0)
                     for p, rec in paths.items() if "launches_per_decode_forward" in rec},
                 "launches_per_train_step": {
                     p: rec["launches_per_step"][0].get(name, 0)
                     for p, rec in paths.items() if "launches_per_step" in rec},
                 "max_abs_err": main["max_abs_err"],
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"], "cases": recs}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name in ALSO_SOURCE:
            entry["also_source"] = ALSO_SOURCE[name]
        out.append(entry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the Llama 8B serving phase (width is never cut)")
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    if not (REPO / "paddle_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: paddle_tpu_torch is not beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    t_start = time.perf_counter()
    cases, paths = {}, {}
    try:
        phase_card()
        if "build" in phases or "kernels" in phases or "kernel_gate" in phases:
            phase_build()
        if "kernels" in phases:
            cases = phase_kernels()
        if "kernel_gate" in phases:
            paths["kernel_gate"] = phase_kernel_gate(args.seed)
        if "parity" in phases:
            phase_parity(args.seed)
        if "train" in phases:
            paths["train"] = phase_train("profile" in phases)
        if "longctx_train" in phases:
            paths["longctx_train"] = phase_longctx_train("profile" in phases)
        if "fuse_train" in phases:
            paths["fuse_train"] = phase_fuse_train("profile" in phases, paths.get("train"))
        if "ssd_train" in phases:
            paths["ssd_train"] = phase_ssd_train("profile" in phases)
        if "serve" in phases:
            serve_paths, model = phase_serve(args.seed, args.layers)
            paths.update(serve_paths)
            if "profile" in phases:
                phase_profile(model, args.seed)
            del model
            torch.cuda.empty_cache()
        if "ssd_serve" in phases:
            paths.update(phase_ssd_serve(args.seed, "profile" in phases))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"chip_smoke: phases {phases} in {time.perf_counter() - t_start:.1f} s")
    if cases:
        log(json.dumps({"kernels": kernel_table(cases, paths)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
