"""``paddle.flops``: the forward FLOPs of a model (port of
``paddle_tpu/hapi/flops.py``).

The JAX package lowers the forward and reads XLA's cost analysis, which
counts every op, elementwise work included.  The port runs one forward on
zeros of the given shapes under ``torch.utils.flop_counter.FlopCounterMode``
(a counter over the dispatched ops, not a kernel), which counts the
products: matrix products, convolutions and attention, at 2 FLOPs a
multiply-add.  So the port's count is the products' FLOPs exactly and the
JAX count is that plus the elementwise work.  The forward runs in eval
mode under ``no_grad`` (the mode is restored), so no BatchNorm statistic
moves and no dropout draw is taken.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..framework.dtype import to_dtype

__all__ = ["flops"]


def flops(net, input_size: Sequence[int], dtypes=None, custom_ops=None,
          print_detail: bool = False) -> int:
    """Total forward FLOPs of ``net`` at ``input_size`` (one shape, or a list
    of shapes for a forward of several inputs; ``dtypes`` theirs, float32
    by default).  ``custom_ops`` is taken for the reference's signature and
    unused."""
    from torch.utils.flop_counter import FlopCounterMode

    if input_size and isinstance(input_size[0], (list, tuple)):
        shapes = [tuple(s) for s in input_size]
    else:
        shapes = [tuple(input_size)]
    if dtypes is None:
        dtypes = ["float32"] * len(shapes)
    p = next(net.parameters(), None)
    dev = p.device if p is not None else torch.device("cpu")
    examples = [torch.zeros(s, dtype=to_dtype(d), device=dev) for s, d in zip(shapes, dtypes)]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            net(*examples)
    finally:
        if was_training:
            net.train()
    total = int(counter.get_total_flops())

    if print_detail:
        rows = [("Layer", "Params", "Param shape(s)")]
        for name, layer in net.named_modules():
            ps = list(layer.parameters(recurse=False))
            if not ps:
                continue
            rows.append((name or type(layer).__name__,
                         str(sum(int(np.prod(tuple(q.shape))) for q in ps)),
                         ", ".join(str(list(q.shape)) for q in ps)))
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        for r in rows:
            print("  ".join(c.ljust(w) for c, w in zip(r, widths)))
        print(f"Total params: {sum(q.numel() for q in net.parameters())}")
        print(f"Total FLOPs (products, FlopCounterMode): {total}")
    return total
