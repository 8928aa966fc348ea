#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one NVIDIA GPU: build the CUDA kernels,
hold each against its plain PyTorch version, check the card against the CPU,
pretrain the `base` preset for a few steps through TrainStep, and serve
Llama-3-8B-shaped requests through the port's Engine.

    python3 chip_smoke.py                  # every phase, full depth
    python3 chip_smoke.py --layers 8       # cut serving depth (never width)
    python3 chip_smoke.py --phases card,build,kernels,train

Phases:
  1 card     name and power limit (nvidia-smi), torch device name
  2 build    nvcc of kernels/csrc/*.cu for sm_90a, all in parallel
  3 kernels  each kernel against its plain version at its path's shapes
             (flash attention forward and backward at `base` and at
             `longctx`, AdamW on base's largest leaf and on all 75):
             max error, kernel / plain / library time, bound; flash
             gradients also tile by tile, and planted faults in them must
             be rejected
  4 parity   card (kernels) against CPU (plain versions) in fp32 on a
             narrow config: Engine and generate tokens must be equal;
             three TrainStep steps must agree in losses, step-1 gradients,
             parameters and the optimizer's m and v slots
  5 train    the `base` preset (12 layers, batch 3, seq 2048, bf16 compute,
             fp32 params) for 5 steps on one batch with the
             launch counters zeroed just before and read just after: every
             step must launch flash forward and backward once a layer,
             RMSNorm twice a layer plus once, AdamW once a leaf (inside the
             optimizer update) and no decode kernel; losses finite and
             falling; step 1's loss within a limit of the same batch run
             with fp32 activations.  Step time, tokens/s and MFU are printed
  6 serve    llama3_8b_config, bf16, random weights from --seed, three
             paths each with the launch counters zeroed just before it and
             read just after it: 16 requests (two share a 256-token prefix)
             through the Engine, one chunked-prefill request through a
             second Engine, generate on two prompts.  Every decode step of
             each path must launch its decode kernel once a layer and
             RMSNorm twice a layer plus once; generate's and the Engine's
             first-token logits must agree within a bf16 limit

  7 profile  (a diagnostic: it prints and checks nothing) one
             decode-dominated Engine drain at 8B widths and one `base`
             training step under torch.profiler: device time by kernel,
             and the device's busy share of the wall time

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}.  Any failed phase exits non-zero before that
line; without CUDA, or outside a checkout of the repo, it exits non-zero at
once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory bandwidth (data sheet)
FP32_FLOPS_PER_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
RMS_TOL = (1e-3, 1.6e-2)     # (atol, rtol): two bf16 ulps of the plain value
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
# step 1's loss at `base` in bf16 against the same weights and batch with
# fp32 activations: at most this far apart (prediction in PERF.md)
TRAIN_LOSS_TOL = 1e-2
# (atol, rtol): the same bf16 rounding limit.  Decode outputs are O(sqrt(1/L))
# (0.04-0.05 at L = 1024-2048), so one dropped or double-counted key, or a
# misweighted split in the combine pass, moves them far past it
DECODE_TOL = (1e-3, 1.6e-2)
# first-token logits of generate (B=1, exact length) against the Engine's
# (bucket-padded batched prefill) at 8B widths in bf16: their max |difference|
# over the vocabulary may be at most this multiple of generate's own bf16
# error, its max |difference| from the same prefill with fp32 activations
LOGIT_TOL = 2.0
ALL_PHASES = ("card", "build", "kernels", "parity", "train", "serve", "profile")
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


def within(a, b, tol, scaled=False):
    """|a - b| <= atol + rtol |b|; with ``scaled`` the atol is multiplied by
    max(1, max |b|)."""
    atol, rtol = tol
    a, b = a.float(), b.float()
    if scaled:
        atol = atol * max(1.0, float(b.abs().max()))
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


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


def _dense_case(gen):
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da

    B, C, H, Hk, D = 8, 2048, 32, 8, 128
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, C, Hk, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, C, Hk, D, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor([1, 37, 128, 129, 500, 1024, 2047, 2048],
                           dtype=torch.int32, device="cuda")
    sm = 1.0 / D ** 0.5
    out = da.masked_multihead_attention(q, k, v, lengths)
    ref = da._decode_reference(q, k, v, lengths, sm)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    check(within(out, ref, DECODE_TOL), f"dense decode disagrees: max err {err}")
    b_ms, b_by = _decode_bound(lengths.tolist(), Hk, D, H, 2, B)
    rec = {"shape": {"B": B, "C": C, "H": H, "Hk": Hk, "D": D,
                     "lengths": lengths.tolist()}, "dtype": "bfloat16",
           "max_abs_err": err, "tol": {"atol": DECODE_TOL[0], "rtol": DECODE_TOL[1]},
           "ms": time_ms(lambda: da.masked_multihead_attention(q, k, v, lengths)),
           "plain_ms": time_ms(lambda: da._decode_reference(q, k, v, lengths, sm)),
           "library_ms": _sdpa_ms(q, k, v, lengths),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"decode dense: {json.dumps(rec)}")
    return rec


def _paged_case(gen):
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da

    B, NB, H, Hk, bs, D, MAXB = 8, 512, 32, 8, 128, 128, 8
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    kp = torch.randn(NB, Hk, bs, D, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(NB, Hk, bs, D, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = [0, 1, 128, 129, 256, 300, 777, 1024]
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
    check(bool(torch.isfinite(out.float()).all()), "paged decode: NaN trash leaked")
    check(bool((out[0] == 0).all()), "paged decode: lengths==0 row is not zero")
    err = max_err(out, ref)
    check(within(out, ref, DECODE_TOL), f"paged decode disagrees: max err {err}")
    b_ms, b_by = _decode_bound(lengths, Hk, D, H, 2, B)
    kg, vg = da._gather_pool(kp, table), da._gather_pool(vp, table)
    rec = {"shape": {"B": B, "pool": [NB, Hk, bs, D], "maxb": MAXB, "H": H,
                     "lengths": lengths}, "dtype": "bfloat16",
           "max_abs_err": err, "tol": {"atol": DECODE_TOL[0], "rtol": DECODE_TOL[1]},
           "ms": time_ms(lambda: da.paged_decode_attention(q, kp, vp, table, len_t)),
           "plain_ms": time_ms(lambda: da._paged_pool_reference(q, kp, vp, table, len_t, sm)),
           "library_ms": _sdpa_ms(q, kg, vg, len_t),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"decode paged: {json.dumps(rec)}")
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


def _sdpa_train_ms(q, k, v, do, backward, iters):
    """One library call on the same inputs: causal GQA
    scaled_dot_product_attention, forward only or forward + backward."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.detach().transpose(1, 2) for x in (q, k, v))
    dot = do.transpose(1, 2)
    if not backward:
        return time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters)
    qg, kg, vg = (x.requires_grad_() for x in (qt.clone(), kt.clone(), vt.clone()))

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    return time_ms(fwd_bwd, iters)


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
    (f_ms, f_by), (b_ms, b_by) = _flash_bounds(B, S, H, Hk, D)
    tol = {"atol": FLASH_TOL[0], "rtol": FLASH_TOL[1], "atol_scaled_by_max_abs": True,
           "grad_tile_rows": FLASH_GRAD_TILE, "grad_tile_norm_rtol": FLASH_GRAD_RTOL}
    fwd = {"shape": shape, "dtype": "bfloat16", "max_abs_err": err_o,
           "max_abs_err_lse": err_lse, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, sm), iters),
           "plain_ms": None if heads else time_ms(
               lambda: fa._flash_fwd_reference(q, k, v, True, sm), iters),
           "library_ms": _sdpa_train_ms(q, k, v, do, False, iters),
           "library": "scaled_dot_product_attention(is_causal, enable_gqa) forward",
           "bound_ms": f_ms, "bound_by": f_by}
    bwd = {"shape": shape, "dtype": "bfloat16", "max_abs_err": max(errs.values()),
           "max_abs_err_by_grad": errs, "tile_norm_err_by_grad": tile_errs,
           "planted_faults": faults, "tol": tol,
           "ms": time_ms(lambda: fa.flash_attention_bwd(q, k, v, o_in, lse_in, do, True, sm),
                         iters),
           "plain_ms": None if heads else time_ms(
               lambda: fa._flash_bwd_reference(q, k, v, o_in, lse_in, do, True, sm), iters),
           "library_ms": _sdpa_train_ms(q, k, v, do, True, iters),
           "library": "scaled_dot_product_attention forward + backward (no backward-only call)",
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


def _adamw_case(gen, shapes, label):
    """The AdamW kernel over ``shapes`` (one launch a leaf) against the plain
    version on the same fp32 p, g, m, v, at step 10 of `base`'s AdamW."""
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
    state = [[x.clone() for x in (p, m, v)] for p, g, m, v in leaves]

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


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {"rms_norm": [_rms_case(8, 4096, gen, torch.bfloat16),
                          _rms_case(8 * 512, 4096, gen, torch.bfloat16),
                          _rms_case(3 * 2048, 2048, gen, torch.float32)],
             "decode_attention_dense": [_dense_case(gen)],
             "decode_attention_paged": [_paged_case(gen)]}
    base = _flash_case(gen, 3, 2048, 16, 8, 128)
    longctx = _flash_case(gen, 1, 16384, 16, 8, 128, heads=2)
    cases["flash_attention_fwd"] = [base[0], longctx[0]]
    cases["flash_attention_bwd"] = [base[1], longctx[1]]
    shapes = _base_leaf_shapes()
    cases["adamw"] = [_adamw_case(gen, shapes, "base, all 75 leaves"),
                      _adamw_case(gen, [shapes[5]], "base, gate_up_proj")]
    torch.cuda.empty_cache()
    return cases


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
    _train_parity(cfg, cpu, gpu, seed)


def _train_parity(cfg, cpu, gpu, seed, steps=3, lr=3e-4):
    """Training on the card (flash, RMSNorm and AdamW kernels) against the
    CPU (plain versions) in fp32 from the same weights: step-1 gradients
    within ``PARITY_GRAD_TOL`` (sums in another order); after ``steps``
    TrainStep steps the losses within rtol 1e-5, the m and v slots within
    ``PARITY_SLOT_TOL`` and the parameters within ``PARITY_PARAM_ATOL``."""
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
              f"parity: step-1 gradient of {n} differs by {max_err(g.cpu(), ref)}")

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
                  f"parity: slot {s} of {n} differs by {max_err(a, b)} after {steps} steps")
    log(f"parity: training {steps} steps, losses cpu {losses['cpu']} card {losses['cuda']}; "
        f"step-1 gradient max err {gerr:.3e}; parameter max err {perr:.3e} (limit "
        f"{PARITY_PARAM_ATOL:.1e}); step-{steps} slot max err / max |slot| m {serr['m']:.3e} "
        f"v {serr['v']:.3e}; card launches {counts}")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        check(abs(a - b) <= 1e-5 * abs(b), f"parity: training losses differ: {losses}")
    check(perr <= PARITY_PARAM_ATOL, f"parity: parameters differ by {perr} after {steps} steps")
    check(counts["flash_attention_fwd"] == steps * cfg.num_hidden_layers
          and counts["adamw"] == steps * len(list(gpu.parameters())),
          f"parity: the card's training steps did not run the kernels: {counts}")


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


def phase_train(profile):
    """`base` pretraining at full width and depth through the port's
    entry points, ``TRAIN_STEPS`` steps; see the module docstring."""
    import math

    import torch
    from paddle_tpu_torch.kernels import launch_counts
    from paddle_tpu_torch.models.presets import build_pretrain_step, model_flops_per_token

    t0 = time.perf_counter()
    step_fn, ids, model, cfg, (B, S, _) = build_pretrain_step("base", "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"train: base preset, {cfg.num_hidden_layers} layers, {n_params} params "
        f"(dtype {cfg.dtype}, params {cfg.pdtype}), batch {B} x seq {S}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    # step 1's weights and batch with fp32 activations, before any update
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        saved = cfg.dtype
        cfg.dtype = "float32"
        try:
            loss32 = float(model.compute_loss(model(ids), ids))
        finally:
            cfg.dtype = saved
    torch.cuda.reset_peak_memory_stats()
    losses, walls, rec = _drive_train(step_fn, ids, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_hidden_layers
    n_leaves = len(list(model.parameters()))
    want = dict.fromkeys(launch_counts(), 0)
    want.update(rms_norm=2 * L + 1, flash_attention_fwd=L, flash_attention_bwd=L,
                adamw=n_leaves)
    want_update = dict.fromkeys(launch_counts(), 0)
    want_update["adamw"] = TRAIN_STEPS * n_leaves
    step_ms = [w * 1e3 for w in walls]
    steady = sum(step_ms[1:]) / (TRAIN_STEPS - 1)      # step 1 includes the warm-up
    flops = model_flops_per_token(cfg, S) * B * S
    log(f"train: losses {losses}; fp32-activation loss at step 1's weights {loss32} "
        f"(|bf16 - fp32| {abs(losses[0] - loss32):.6g}, limit {TRAIN_LOSS_TOL})")
    log(f"train: step ms {step_ms}; steady {steady:.3f} ms = {B * S / steady * 1e3:.1f} "
        f"tokens/s, MFU {flops / (steady / 1e3) / BF16_FLOPS_PER_S:.4f} "
        f"({flops / 1e12:.2f} TFLOP a step at {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s); "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"train: launches {json.dumps(rec)}")
    check(all(math.isfinite(x) for x in losses), f"train: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    for i, got in enumerate(rec["launches_per_step"]):
        check(got == want, f"train: step {i + 1} launched {got}, expected {want}")
    check(rec["launches_in_update"] == want_update,
          f"train: launches inside the optimizer update {rec['launches_in_update']}, "
          f"expected {want_update}")
    check(abs(losses[0] - loss32) <= TRAIN_LOSS_TOL,
          f"train: step 1's bf16 loss {losses[0]} is {abs(losses[0] - loss32)} from the "
          f"fp32-activation loss {loss32}, past {TRAIN_LOSS_TOL}")
    rec.update(losses=losses, step_ms=step_ms, steady_step_ms=steady, loss_fp32=loss32,
               peak_bytes=peak)
    if profile:
        _profile(lambda: step_fn(ids), "train: one base step")
    del step_fn, model
    torch.cuda.empty_cache()
    return rec


def _profile(fn, label):
    """torch.profiler over one call of ``fn``: device kernel time by name
    and the device's busy share of the wall time (prints, checks nothing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    log(f"profile: {label}: wall {wall_ms:.3f} ms, kernels {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}% of wall)")
    groups = {"flash": ("flash_",), "gemm (cuBLAS)": ("nvjet", "gemm", "cutlass"),
              "adamw": ("adamw_",), "rms_norm": ("rms_norm_",), "decode": ("decode_",)}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for ms, _, key in rows:
        name = next((g for g, marks in groups.items() if any(m in key for m in marks)), "other")
        by_group[name] += ms
    log(f"profile: {label}: device ms by group {json.dumps(by_group)}")
    for ms, count, key in rows[:15]:
        log(f"profile:   {ms:10.3f} ms {count:7d}x  {key[:100]}")
    return wall_ms, rows


def _drive_path(model, drive):
    """Set every launch count to 0, run ``drive()``, and read the counts just
    after it.  Each forward of ``model.llama`` is also tallied by its role:
    one token a row is a decode step, more is a prefill.  Returns
    ``(drive's result, record)``; the record holds the path's counts, its
    decode steps and prefill forwards, and the launches each of them made."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts

    roles = {r: {"forwards": 0, "launches": dict.fromkeys(launch_counts(), 0)}
             for r in ("decode", "prefill")}
    fwd = model.llama.forward

    def counted(input_ids, *a, **kw):
        before = launch_counts()
        out = fwd(input_ids, *a, **kw)
        role = roles["decode" if input_ids.shape[1] == 1 else "prefill"]
        role["forwards"] += 1
        for name, n in launch_counts().items():
            role["launches"][name] += n - before[name]
        return out

    model.llama.forward = counted
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        result = drive()
        torch.cuda.synchronize()
        counts = launch_counts()
    finally:
        del model.llama.forward
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


def _check_path(name, rec, n_layers, decode_kernel):
    """Every decode step of the path launches ``decode_kernel`` once a layer
    and no other decode kernel, RMSNorm twice a layer plus the final norm;
    every prefill forward launches RMSNorm alike and no decode kernel."""
    from paddle_tpu_torch.kernels import launch_counts

    norms = 2 * n_layers + 1
    check(rec["decode_forwards"] > 0, f"serve: {name} ran no decode step")
    want = dict.fromkeys(launch_counts(), 0)
    want["rms_norm"] = norms
    want[decode_kernel] = n_layers
    got = rec["launches_per_decode_forward"]
    check(got == want, f"serve: {name} launches a decode step {got}, expected {want}")
    if rec["prefill_forwards"]:
        want = dict(want, **{decode_kernel: 0})
        got = rec["launches_per_prefill_forward"]
        check(got == want, f"serve: {name} launches a prefill forward {got}, expected {want}")


def phase_serve(seed, layers):
    import numpy as np
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
    # NaN watch on every vocab projection (device-side flag, no sync); while
    # ``head_sink`` is a list, each projection is also kept there
    nan_seen = torch.zeros((), dtype=torch.bool, device="cuda")
    head = model.head
    head_sink = None

    def watched_head(hidden):
        out = head(hidden)
        nan_seen.logical_or_(torch.isnan(out).any())
        if head_sink is not None:
            head_sink.append(out)
        return out

    model.head = watched_head
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, cfg.vocab_size, size=(256,)).astype(np.int32)
    lens = [int(x) for x in rng.integers(128, 513, size=14)] + [-100, -150]
    news = [int(x) for x in rng.integers(32, 129, size=16)]
    reqs = _requests(rng, cfg.vocab_size, lens, news, prefix)
    chunk_req = _requests(rng, cfg.vocab_size, [400], [48])
    gen_reqs = reqs[:2]
    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    from paddle_tpu_torch.serving import Engine

    Engine(model, device="cuda", num_blocks=16, **kw).warmup()

    # the Engine's first-token logits of gen_reqs, from its batched prefill
    # (one projected row per request of the group, in group order)
    eng_first = {}

    def keep_first_logits(eng):
        run = eng._run_prefill

        def run_prefill(group, Pb, fidx0):
            nonlocal head_sink
            head_sink = []
            run(group, Pb, fidx0)
            (lg,), head_sink = head_sink, None
            for j, e in enumerate(group):
                for i, r in enumerate(gen_reqs):
                    if e[1] is r:
                        eng_first[i] = lg[j].float()

        eng._run_prefill = run_prefill

    paths = {}
    t0 = time.perf_counter()
    (eng, outs), paths["engine"] = _drive_path(model, lambda: _serve(
        model, reqs, "cuda", hook=keep_first_logits, num_blocks=512, **kw))
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
    check(not bool(nan_seen), "serve: NaN logits")
    _check_path("engine", paths["engine"], layers, "decode_attention_paged")
    _check_path("engine_chunked", paths["engine_chunked"], layers, "decode_attention_paged")
    _check_path("generate", paths["generate"], layers, "decode_attention_dense")

    # generate against the Engine on the first token: generate's prefill
    # (B=1, exact length) rebuilt as it runs, in bf16 and with fp32
    # activations (the config's own mixed-precision mode: bf16 params, fp32
    # compute), against the Engine's captured row
    check(sorted(eng_first) == [0, 1], "serve: Engine first-token logits not captured")
    torch.backends.cuda.matmul.allow_tf32 = False

    def first_logits(prompt, dtype):
        ids = torch.from_numpy(prompt[None]).to("cuda", torch.int32)
        cache = model.init_cache(1, len(prompt) + 16, dtype=dtype)
        hidden, _ = model.llama(ids, cache=cache)
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
            log(f"serve: prompt {i} (P={P}) first-token logits: max |generate - Engine| "
                f"{diff:.6g}; max |bf16 - fp32 activations| generate {err_gen:.6g}, "
                f"Engine {err_eng:.6g} (limit {LOGIT_TOL} x generate's); max |logit| "
                f"{float(ref.abs().max()):.6g}; generate's top-1 - top-2 gap "
                f"{float(gap[0] - gap[1]):.6g}; first token generate {int(ref.argmax())} "
                f"Engine {int(lg.argmax())} fp32 {int(exact.argmax())}")
            check(int(ref.argmax()) == int(g[0, P]), f"serve: prompt {i}: rebuilt "
                  "prefill disagrees with generate's first token")
            check(int(lg.argmax()) == o.output_ids[0], f"serve: prompt {i}: captured "
                  "logits disagree with the Engine's first token")
            check(diff <= LOGIT_TOL * err_gen and err_eng <= LOGIT_TOL * err_gen,
                  f"serve: prompt {i}: the Engine's first-token logits are {diff} from "
                  f"generate's and {err_eng} from fp32, past {LOGIT_TOL} x generate's "
                  f"own bf16 error {err_gen}")
            toks = g[0, P:].tolist()
            diverge.append(next((j for j, (a, b) in enumerate(zip(toks, o.output_ids))
                                 if a != b), None))
    log(f"serve: first position where generate's and the Engine's 16 tokens differ, "
        f"per prompt: {diverge} (None = all equal)")
    model.head = head
    return paths, model


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
    "decode_attention_dense": ("paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                               "paddle_tpu/kernels/decode_attention.py:194"),
    "decode_attention_paged": ("paddle_tpu_torch/kernels/csrc/decode_attention.cu",
                               "paddle_tpu/kernels/decode_attention.py:490"),
    "flash_attention_fwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:210"),
    "flash_attention_bwd": ("paddle_tpu_torch/kernels/csrc/flash_attention.cu",
                            "paddle_tpu/kernels/flash_attention.py:447"),
    "adamw": ("paddle_tpu_torch/kernels/csrc/adamw.cu", "paddle_tpu/kernels/adamw.py:79"),
}
ALSO_REPLACES = {
    "decode_attention_dense": "paddle_tpu/kernels/decode_attention.py:87",
    "decode_attention_paged": "paddle_tpu/kernels/decode_attention.py:389",
    "flash_attention_fwd": "paddle_tpu/kernels/flash_attention.py:115",
    "flash_attention_bwd": "paddle_tpu/kernels/flash_attention.py:290",
}


# the path whose run ``launches`` reports for each kernel
MAIN_PATH = {"rms_norm": "engine", "decode_attention_dense": "generate",
             "decode_attention_paged": "engine", "flash_attention_fwd": "train",
             "flash_attention_bwd": "train", "adamw": "train"}


def kernel_table(cases, paths):
    out = []
    for name, recs in cases.items():
        main = recs[0]
        src, rep = SOURCES[name]
        by_path = {p: rec["launches"][name] for p, rec in paths.items()}
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": by_path.get(MAIN_PATH[name]),
                 "launches_by_path": by_path,
                 "launches_per_decode_step": {
                     p: rec["launches_per_decode_forward"][name]
                     for p, rec in paths.items() if p != "train"},
                 "launches_per_train_step": (paths["train"]["launches_per_step"][0][name]
                                             if "train" in paths else None),
                 "max_abs_err": main["max_abs_err"],
                 "ms": main["ms"], "plain_ms": main["plain_ms"],
                 "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                 "library_ms": main["library_ms"], "cases": recs}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        out.append(entry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32,
                    help="decoder depth of the 8B serving phase (width is never cut)")
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
        if "build" in phases or "kernels" in phases:
            phase_build()
        if "kernels" in phases:
            cases = phase_kernels()
        if "parity" in phases:
            phase_parity(args.seed)
        if "train" in phases:
            paths["train"] = phase_train("profile" in phases)
        if "serve" in phases:
            serve_paths, model = phase_serve(args.seed, args.layers)
            paths.update(serve_paths)
            if "profile" in phases:
                phase_profile(model, args.seed)
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
