#!/usr/bin/env python3
"""Time hand-written kernels of one or more checkouts of the port on the
same inputs, each checkout in its own process, in the order given (for a
comparison on one card: parent, change, change, parent).

    python3 kernel_ab.py SET [--split-keys N] DIR [DIR ...]   # each DIR holds paddle_tpu_torch/

Sets:

- ``gemm``: the fusion sites' ten bf16 GEMM launches at `base` (operands
  bf16, weights already rounded, as the sites' tensor-core launches read
  them).
- ``serve``: the serving path's two kernels.  RMSNorm at a decode step
  [8, 4096], at the Engine's prefill forwards [512, 4096] and [2048, 4096]
  and at [4096, 4096] (bf16 over a bf16 weight), and at a `base` training
  step [6144, 2048] (bf16 over fp32); decode attention dense (B 8, C 2048,
  H 32 over Hk 8, D 128) and paged (the Engine's pool [512, 8, 128, 128], 8
  blocks a row, NaN in the trash block and in stale tails) at the kernel
  table's lengths and at the `serve` phase's own lengths.  Each output is
  also hashed (sha256 prefix), so checkouts can be held to the same bits,
  and each decode output is held to its plain version within
  ``chip_smoke.DECODE_TOL``.
- ``rms_plan``: each RMSNorm kernel (``plan``'s two choices forced) at the
  row counts the serving path gives it, for checkouts with
  ``rms_norm.plan``.
- ``tokens``: the Engine drain and `generate` of ``chip_smoke.py``'s
  `serve` phase (Llama-3-8B widths, 32 layers) and of its `ssd_serve` phase
  (SSD-8B), random weights from seed 0: sha256 prefixes of the greedy
  tokens, and (for checkouts with ``rms_norm.plan``) the RMSNorm launches
  of the `serve` drain by row count.
- ``ssd``: the SSD scan at the `ssd_train` shape (G 128, T 4096, P 64, N
  128, chunk 128) and SSDConfig()'s (G 64, T 4096, P 128, N 64, chunk 64):
  the forward (``ssd_scan``) and the backward (autograd of its outputs,
  the graph kept: the backward kernels where the checkout has them, the
  plain recompute where not), inputs and cotangents from seed 0 as
  ``chip_smoke.py``'s ``_ssd_case`` makes them; each output's largest
  error over the plain version's largest |value| (the plain scan and
  autograd of it).  Equal bits are not expected.

- ``norm``: the add + RMSNorm forward at `base` ([6144, 2048] bf16 over an
  fp32 weight; output hashes and ms), the RMSNorm backward at five cases
  (the ``fuse_add_rms_norm`` site's, with h and d_s, at `base`; the stock
  RMSNorm's, ``rms_norm_backward``, at `base`'s, `longctx`'s [16384,
  2048] and `ssd_train`'s [8192, 4096] rows over fp32 weights, and fp32
  rows [512, 256]) with each output's error against an fp64 plain
  backward and its ms (in a checkout without the kernel the stock cases
  run its plain ``rms_norm_backward``), and five `base` training steps
  (losses, step ms, the steady step, peak memory).

``--split-keys N`` builds decode attention with N keys a CTA of its first
pass instead of ``_build.GEOMETRY``'s (a multiple of 32).  Every launch is
timed alone by ``chip_smoke.time_ms`` (CUDA events after an L2 flush).
Prints one JSON line a checkout: ``{"tree", "card", "set", ...}``.  Needs
a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SETS = ("gemm", "serve", "rms_plan", "tokens", "ssd", "norm")
SSD_SHAPES = {"ssd_train": (128, 4096, 64, 128, 128), "SSDConfig()": (64, 4096, 128, 64, 64)}
TABLE_DENSE = [1, 37, 128, 129, 500, 1024, 2047, 2048]
TABLE_PAGED = [0, 1, 128, 129, 256, 300, 777, 1024]
# RMSNorm rows of the serving path: a decode step's 8 and the Engine's
# prefill forwards, n requests of one bucket (n in 4/2/1, buckets 128-512)
SERVE_ROWS = (8, 128, 256, 384, 512, 768, 1024, 1536, 2048, 4096)


def _smoke():
    """This script's chip_smoke.py: the same inputs for every checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(t) -> str:
    import torch

    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def _rnd(gen, *shape, dt=None, std=1.0):
    import torch

    return (std * torch.randn(*shape, generator=gen, device="cuda")).to(dt or torch.bfloat16)


def _gemm_cases():
    import torch
    from paddle_tpu_torch.kernels import fused_gemm as fg

    M, H, I, V = 3 * 2048, 2048, 5632, 32000     # `base`: rows, hidden, intermediate, vocab
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dy, act = _rnd(gen, M, H), _rnd(gen, M, H), _rnd(gen, M, I)
    d_gu, d_logits = _rnd(gen, M, 2 * I), _rnd(gen, M, V)
    wd, wh = _rnd(gen, I, H, std=0.02), _rnd(gen, H, V, std=0.02)
    wgu = _rnd(gen, H, 2 * I, std=0.02)
    f32 = torch.float32
    return {
        "gate_up+swiglu": lambda: fg.swiglu_gate_up(x, wgu, I),
        "down": lambda: fg.matmul(act, wd),
        "d_act": lambda: fg.matmul(dy, wd, b_t=True),
        "gate_up+swiglu_bwd": lambda: fg.swiglu_gate_up_bwd(x, wgu, act, I),
        "d_w_down": lambda: fg.matmul(act, dy, a_t=True, out_dtype=f32),
        "d_hidden": lambda: fg.matmul(d_gu, wgu, b_t=True),
        "d_w_gate_up": lambda: fg.matmul(x, d_gu, a_t=True, out_dtype=f32),
        "head": lambda: fg.matmul(x, wh),
        "d_normed": lambda: fg.matmul(d_logits, wh, b_t=True),
        "d_w_head": lambda: fg.matmul(x, d_logits, a_t=True, out_dtype=f32),
    }, {}


def _serve_cases(smoke):
    """{case: launch} and {case: plain version} on inputs from fixed seeds."""
    import torch
    from paddle_tpu_torch.kernels import decode_attention as da
    from paddle_tpu_torch.kernels.rms_norm import rms_norm

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    cases, plain = {}, {}
    for rows, d, w_dt in ((8, 4096, bf), (512, 4096, bf), (2048, 4096, bf), (4096, 4096, bf),
                          (6144, 2048, torch.float32)):
        x, w = _rnd(gen, rows, d), (1.0 + _rnd(gen, d, dt=torch.float32, std=0.1)).to(w_dt)
        label = f"rms_norm [{rows}, {d}]" + (" fp32 w" if w_dt != bf else "")
        cases[label] = lambda x=x, w=w: rms_norm(x, w, 1e-6)

    B, H, Hk, D, bs, NB, MAXB = 8, 32, 8, 128, 128, 512, 8
    sm = D ** -0.5
    serve = smoke._serve_lengths()
    for label, lengths, C in (("decode dense (table)", TABLE_DENSE, 2048),
                              ("decode dense (serve)", serve, 1024)):
        q, k, v = _rnd(gen, B, 1, H, D), _rnd(gen, B, C, Hk, D), _rnd(gen, B, C, Hk, D)
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        cases[label] = lambda q=q, k=k, v=v, ln=ln: da.masked_multihead_attention(q, k, v, ln)
        plain[label] = lambda q=q, k=k, v=v, ln=ln: da._decode_reference(q, k, v, ln, sm)
    for label, lengths in (("decode paged (table)", TABLE_PAGED),
                           ("decode paged (serve)", serve)):
        q, kp, vp = _rnd(gen, B, 1, H, D), _rnd(gen, NB, Hk, bs, D), _rnd(gen, NB, Hk, bs, D)
        kp[0] = vp[0] = float("nan")
        table = torch.zeros(B, MAXB, dtype=torch.int32)
        nxt = 1
        for b, L in enumerate(lengths):
            n = -(-L // bs)
            table[b, :n] = torch.arange(nxt, nxt + n)
            nxt += n
            if L % bs:
                kp[int(table[b, n - 1]), :, L % bs:] = float("nan")
                vp[int(table[b, n - 1]), :, L % bs:] = float("nan")
        table = table.cuda()
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        cases[label] = (lambda q=q, kp=kp, vp=vp, table=table, ln=ln:
                        da.paged_decode_attention(q, kp, vp, table, ln))
        plain[label] = (lambda q=q, kp=kp, vp=vp, table=table, ln=ln:
                        da._paged_pool_reference(q, kp, vp, table, ln, sm))
    return cases, plain


def _rms_plan_cases():
    """Each kernel ``plan`` can pick, forced, at the serving path's rows of
    4096 (bf16 weight) and at a `base` training step's 6144 rows of 2048
    (fp32 weight)."""
    import torch
    from paddle_tpu_torch.kernels import rms_norm as rn

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows_nv = {4096: rn.plan(1 << 20, 4096, torch.bfloat16)[1],
               2048: rn.plan(1 << 20, 2048, torch.bfloat16)[1]}
    real_plan = rn.plan
    cases = {}
    for rows, d, w_dt in [(r, 4096, torch.bfloat16) for r in SERVE_ROWS] + [
            (6144, 2048, torch.float32)]:
        x, w = _rnd(gen, rows, d), (1.0 + _rnd(gen, d, dt=torch.float32, std=0.1)).to(w_dt)
        for kind, nv in (("cta", 0), ("rows", rows_nv[d])):
            def run(x=x, w=w, choice=(kind, nv)):
                rn.plan = lambda *a: choice
                try:
                    return rn.rms_norm(x, w, 1e-6)
                finally:
                    rn.plan = real_plan
            cases[f"{kind} [{rows}, {d}]"] = run
    return cases, {}


def _tokens(smoke) -> dict:
    """sha256 of the greedy tokens of `serve`'s Engine drain and generate
    and of `ssd_serve`'s, as chip_smoke.py's phases drive them; and the
    `serve` drain's RMSNorm launches by row count."""
    import collections

    import torch
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.models import (LlamaForCausalLM, SSDForCausalLM, llama3_8b_config,
                                         ssd_8b_config)

    kw = dict(max_batch=8, block_size=128, prefill_buckets=(128, 256, 512))
    out, rows = {}, collections.Counter()
    real_plan = getattr(rn, "plan", None)
    for name, cls, cfg, reqs, blocks in (
            ("serve", LlamaForCausalLM, llama3_8b_config(),
             smoke._serve_requests(llama3_8b_config().vocab_size, 0)[0], 512),
            ("ssd_serve", SSDForCausalLM, ssd_8b_config(),
             smoke._ssd_serve_requests(ssd_8b_config().vocab_size, 0)[0], 16)):
        model = cls(cfg, device="cuda", seed=0)
        if name == "serve" and real_plan is not None:
            rn.plan = lambda n, d, dt: (rows.update([n]), real_plan(n, d, dt))[1]
        try:
            _, outs = smoke._serve(model, reqs, "cuda", num_blocks=blocks, **kw)
        finally:
            if real_plan is not None:
                rn.plan = real_plan
        gens = [model.generate(r.prompt_ids[None], max_new_tokens=16) for r in reqs[:2]]
        h = hashlib.sha256()
        for o in outs:
            h.update(json.dumps([int(t) for t in o.output_ids]).encode())
        for g in gens:
            h.update(json.dumps(g.tolist()).encode())
        out[name] = h.hexdigest()[:16]
        del model, outs, gens
        torch.cuda.empty_cache()
    rec = {"tokens_sha256": out}
    if real_plan is not None:
        rec["serve_rms_norm_launches_by_rows"] = dict(sorted(rows.items()))
    return rec


def _ssd(smoke) -> dict:
    """The scan's forward and backward times at SSD_SHAPES, with their
    errors against the plain versions."""
    import torch
    from paddle_tpu_torch.kernels import ssd_scan as ts

    rec = {"ms": {}, "max_err_over_max_abs": {}}
    for label, (G, T, P, N, L) in SSD_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        ops = smoke._ssd_inputs(gen, G, T, P, N)
        args = [t.detach().requires_grad_() for t in ops]
        with torch.enable_grad():
            y, s = ts.ssd_scan(*args, chunk=L)
        cts = tuple(torch.randn(t.shape, generator=gen, device="cuda") for t in (y, s))

        def backward():
            return torch.autograd.grad((y, s), args, cts, retain_graph=True)

        got = backward()
        with torch.enable_grad():
            ref = ts.ssd_scan_reference(*args, L)
            want = torch.autograd.grad(ref, args, cts)
        for name, a, r in zip(("y", "s", "dx", "db", "dc", "dla"), (y, s, *got),
                              (*ref, *want)):
            rec["max_err_over_max_abs"][f"{label} {name}"] = (
                smoke.max_err(a, r) / max(float(r.abs().max()), 1e-30))
        del ref, want, got
        for _ in range(3):
            ts.ssd_scan(*ops, chunk=L)
            backward()
        torch.cuda.synchronize()
        rec["ms"][f"{label} forward"] = smoke.time_ms(lambda: ts.ssd_scan(*ops, chunk=L))
        rec["ms"][f"{label} backward"] = smoke.time_ms(backward, 10)
        del y, s, args
        torch.cuda.empty_cache()
    return rec


# the RMSNorm backward's cases: (label, rows, d, rows dtype, h and d_s given)
NORM_CASES = (("site base", 3 * 2048, 2048, "bfloat16", True),
              ("stock base", 3 * 2048, 2048, "bfloat16", False),
              ("stock longctx", 16384, 2048, "bfloat16", False),
              ("stock ssd_train", 2 * 4096, 4096, "bfloat16", False),
              ("stock fp32", 2 * 256, 256, "float32", False))


def _fp64_norm_bwd(x, h, w, d_s, dy, eps):
    """``(dx, dw)`` of the (add +) RMSNorm backward in fp64 from the same
    inputs (``s = x + h`` rounded to x's dtype, as the forward stores it)."""
    import torch

    s = (x if h is None else x + h).double()
    dy64, w64 = dy.double(), w.double()
    r = torch.rsqrt(s.square().mean(-1, keepdim=True) + eps)
    s_hat, g = s * r, dy64 * w64
    dx = r * (g - s_hat * (g * s_hat).mean(-1, keepdim=True))
    if d_s is not None:
        dx = dx + d_s.double()
    return dx, (dy64 * s_hat).sum(0)


def _norm(smoke) -> dict:
    """The add + RMSNorm forward, the RMSNorm backward at NORM_CASES and five
    `base` steps (see the module docstring)."""
    import time

    import torch
    from paddle_tpu_torch.kernels import add_rms_norm as arn
    from paddle_tpu_torch.kernels import rms_norm as rn
    from paddle_tpu_torch.models.presets import build_pretrain_step

    eps = 1e-6
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = {"ms": {}, "sha256": {}, "max_err": {}, "kernel": {}}
    x, h = _rnd(gen, 3 * 2048, 2048), _rnd(gen, 3 * 2048, 2048)
    w = 1 + _rnd(gen, 2048, dt=torch.float32, std=0.1)
    s, y = arn.add_rms_norm_fwd(x, h, w, eps)
    rec["sha256"]["add_rms_norm forward s"], rec["sha256"]["add_rms_norm forward normed"] = (
        _digest(s), _digest(y))
    rec["ms"]["add_rms_norm forward"] = smoke.time_ms(lambda: arn.add_rms_norm_fwd(x, h, w, eps))
    del x, h, s, y
    for label, rows, d, dt, site in NORM_CASES:
        dt = getattr(torch, dt)
        x, dy = _rnd(gen, rows, d, dt=dt), _rnd(gen, rows, d, dt=dt)
        w = 1 + _rnd(gen, d, dt=torch.float32, std=0.1)
        h, d_s = (_rnd(gen, rows, d, dt=dt), _rnd(gen, rows, d, dt=dt)) if site else (None, None)
        if site:
            def run(x=x, h=h, w=w, d_s=d_s, dy=dy):
                dx, _, dw = arn.add_rms_norm_bwd(x, h, w, d_s, dy, eps)
                return dx, dw
        else:
            def run(x=x, w=w, dy=dy):
                return rn.rms_norm_backward(x, w, dy, eps)
        before = rn.rms_norm_backward.launches if hasattr(rn.rms_norm_backward, "launches") \
            else None
        dx, dw = run()
        rec["kernel"][label] = site or (before is not None
                                        and rn.rms_norm_backward.launches == before + 1)
        dx64, dw64 = _fp64_norm_bwd(x, h, w, d_s, dy, eps)
        rec["max_err"][label] = {
            "dx": float((dx.double() - dx64).abs().max()),
            "dw_over_max_abs": float((dw.double() - dw64).abs().max() / dw64.abs().max())}
        del dx, dw, dx64, dw64
        for _ in range(3):
            run()
        rec["ms"][label] = smoke.time_ms(run)
        del x, dy, h, d_s
        torch.cuda.empty_cache()
    step_fn, ids, *_ = build_pretrain_step("base", "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step_fn(ids)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    rec["base_steps"] = {"losses": losses, "step_ms": step_ms,
                         "steady_step_ms": sum(step_ms[1:]) / 4,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
    return rec


def _run_tree(which: str, tree: str, split_keys: int) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from paddle_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    if split_keys:
        _build.GEOMETRY["decode_attention"]["DECODE_SPLIT_KEYS"] = split_keys
    smoke = _smoke()
    if which == "tokens":
        return _tokens(smoke)
    if which == "ssd":
        return _ssd(smoke)
    if which == "norm":
        return _norm(smoke)
    if which == "rms_plan":
        from paddle_tpu_torch.kernels import rms_norm as rn

        if not hasattr(rn, "plan"):
            return {"skipped": "this checkout's RMSNorm has one kernel"}
        cases, plain = _rms_plan_cases()
    else:
        cases, plain = _gemm_cases() if which == "gemm" else _serve_cases(smoke)
    for fn in cases.values():      # builds, first launches and the card's clocks
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    ms, sha, err = {}, {}, {}
    for label, fn in cases.items():
        y = fn()
        sha[label] = _digest(y)
        if label in plain:
            ref = plain[label]()
            err[label] = smoke.max_err(y, ref)
            if not smoke.within(y, ref, smoke.DECODE_TOL):
                raise SystemExit(f"kernel_ab: {label} disagrees with its plain version: "
                                 f"max err {err[label]}")
        ms[label] = smoke.time_ms(fn)
    rec = {"ms": ms, "sha256": sha}
    if err:
        rec["max_abs_err"] = err
    return rec


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) == 4 and args[0] == "--one":
        print(json.dumps(_run_tree(args[1], args[3], int(args[2]))), flush=True)
        return 0
    split_keys = 0
    if "--split-keys" in args:
        i = args.index("--split-keys")
        split_keys = int(args[i + 1])
        del args[i:i + 2]
    if len(args) < 2 or args[0] not in SETS:
        raise SystemExit(__doc__)
    which, trees = args[0], args[1:]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--one", which, str(split_keys), tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        extra = {"split_keys": split_keys} if split_keys else {}
        print(json.dumps({"tree": tree, "card": card, "set": which, **extra, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
