#!/usr/bin/env python3
"""Time the fusion sites' ten bf16 GEMM launches at `base` for one or more
checkouts of the port, each in its own process, in the order given (for a
comparison on one card: parent, change, change, parent).

    python3 gemm_ab.py DIR [DIR ...]     # each DIR holds paddle_tpu_torch/

Operands are bf16 (weights already rounded), as the sites' tensor-core
launches read them; every launch is timed alone with CUDA events after an
L2 flush (chip_smoke.time_ms's method).  Prints one JSON line per
checkout: ``{"tree": DIR, "card": nvidia-smi's name and power limit,
"ms": {product: ms}}``.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys

M, H, I, V = 3 * 2048, 2048, 5632, 32000     # `base`: rows, hidden, intermediate, vocab


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _run_tree(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    from paddle_tpu_torch.kernels import fused_gemm as fg

    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)

    x, dy, act, d_gu, d_logits = rnd(M, H), rnd(M, H), rnd(M, I), rnd(M, 2 * I), rnd(M, V)
    wd, wh, wgu = rnd(I, H, std=0.02), rnd(H, V, std=0.02), rnd(H, 2 * I, std=0.02)
    f32 = torch.float32
    launches = {
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
    }
    return {name: _time_ms(fn) for name, fn in launches.items()}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(_run_tree(args[1])), flush=True)
        return 0
    if not args:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    for tree in args:
        proc = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tree, "card": card, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
