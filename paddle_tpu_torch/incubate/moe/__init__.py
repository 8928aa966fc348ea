"""Mixture-of-Experts (port of ``paddle_tpu/incubate/moe/__init__.py``).

The same routing as the JAX package -- naive / switch / gshard gates,
expert capacity with a queue that runs across slots in token order, the
load-balancing aux loss ``E * sum_e me_e * ce_e`` -- and the same stacked
expert weights ``[E, ...]`` (bias-free SwiGLU experts, router in fp32), in
PyTorch's form rather than the dense one-hot einsums:

- :func:`top_k_gating` returns, for each (token, slot), the expert, its
  queue position, whether it fits the capacity and its normalised gate
  weight (:class:`Routing`); :func:`expand_routing` turns that into the
  JAX package's dense ``[T, E, C]`` combine and dispatch tensors, for tests;
- :func:`dispatch` copies each kept token into its ``expert_in[e, c]`` row
  (zeros in empty slots), an ``autograd.Function`` whose backward gathers
  each token's ``k`` slot gradients and sums them in slot order (no
  scatter-add, so the gradient is the same bits every run);
- :func:`combine` gathers each token's ``k`` slots, times the weights
  rounded to the compute dtype, summed over the slots in fp32.

In exact arithmetic this is the einsums' result; it moves ``T * k`` rows
instead of contracting a ``[T, E, C]`` tensor.  The expert FFN is one
batched product pair over ``[E, C, d]`` (``torch.bmm``), as the JAX package
leaves it to XLA.

Randomness: the ``gshard`` gate keeps a token's second expert by a uniform
draw.  :meth:`MoELayer.forward_with_aux` takes the draws as a tensor (the
model draws them before a recomputed layer, so the recompute sees the same
ones) or draws them from the layer's ``torch.Generator``.

Not ported: ``dispatch_all_to_all`` and expert parallelism over an ``ep``
mesh axis (they come with the distributed slice).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ... import default_device, make_generator, to_dtype

__all__ = ["MoELayer", "Routing", "top_k_gating", "expand_routing", "dispatch", "combine"]

GATES = ("naive", "switch", "gshard")


class Routing(NamedTuple):
    """Where each (token, slot) goes.  All ``[T, k]``: ``expert``, queue
    ``position`` (int64; may pass the capacity), ``kept`` (the slot's gate is
    nonzero and its position fits), ``weight`` (the gate normalised over the
    token's slots, fp32, differentiable) and ``slot`` (``e * C + c`` where
    kept, else ``E * C``: the row past the last)."""
    expert: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    weight: torch.Tensor
    slot: torch.Tensor
    aux_loss: torch.Tensor
    capacity: int
    num_experts: int


def effective_top_k(gate_type: str, top_k: int) -> int:
    """'switch' routes to one expert and 'gshard' to two, whatever ``top_k``."""
    if gate_type not in GATES:
        raise ValueError(f"unknown MoE gate {gate_type!r}; choose from {GATES}")
    return {"switch": 1, "gshard": 2}.get(gate_type, top_k)


def top_k_gating(logits: torch.Tensor, top_k: int, capacity: int, gate_type: str = "gshard",
                 uniforms: Optional[torch.Tensor] = None) -> Routing:
    """Route ``T`` tokens over ``E`` experts from ``logits`` ``[T, E]`` (the
    JAX ``top_k_gating``'s rules).  ``uniforms`` ``[T]`` are the gshard
    gate's draws: the second expert is kept where ``u < 2 g1 / (g0 + g1)``;
    without them every second expert is kept.  Ties in the top-k go to the
    lower expert index, as ``jax.lax.top_k``'s do."""
    T, E = logits.shape
    k = effective_top_k(gate_type, top_k)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    expert = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    vals = torch.gather(probs, 1, expert)
    if gate_type == "gshard" and uniforms is not None:
        u = uniforms.to(device=probs.device, dtype=torch.float32)
        keep2 = u < (2.0 * vals[:, 1] / torch.clamp_min(vals[:, 0] + vals[:, 1], 1e-9))
        vals = torch.stack([vals[:, 0], torch.where(keep2, vals[:, 1], 0.0)], dim=1)
    if gate_type == "naive":
        aux = torch.zeros((), dtype=torch.float32, device=probs.device)
    else:
        me = probs.mean(dim=0)
        ce = F.one_hot(expert[:, 0], E).to(torch.float32).mean(dim=0)
        aux = torch.sum(me * ce) * E
    weight = vals / torch.clamp_min(vals.sum(dim=1, keepdim=True), 1e-9)
    # each expert's queue runs across the slots in token order: a slot-s
    # arrival queues behind every earlier slot's arrivals at that expert.
    # The running count is a scan along the tokens, each expert's a
    # contiguous row ([E, T]: a scan down [T, E]'s columns is slow on a card)
    experts = torch.arange(E, device=probs.device)[:, None]
    base = torch.zeros(E, dtype=torch.int64, device=probs.device)
    positions = []
    for s in range(k):
        e = expert[:, s]
        arrivals = (e[None, :] == experts) & (vals[:, s] > 0)[None, :]   # [E, T]
        count = arrivals.to(torch.int32).cumsum(dim=1)
        rank = torch.gather(count, 0, e[None, :])[0].to(torch.int64) - 1
        positions.append(base[e] + rank)
        base = base + count[:, -1]
    position = torch.stack(positions, dim=1)
    kept = (vals > 0) & (position < capacity)
    slot = torch.where(kept, expert * capacity + position, E * capacity)
    return Routing(expert, position, kept, weight, slot, aux, capacity, E)


def expand_routing(r: Routing):
    """The JAX package's dense form: ``(combine [T, E, C] fp32, dispatch
    [T, E, C] bool)``."""
    T, k = r.expert.shape
    E, C = r.num_experts, r.capacity
    combine = torch.zeros(T, E * C + 1, dtype=torch.float32, device=r.weight.device)
    w = torch.where(r.kept, r.weight.detach(), 0.0)
    combine.scatter_add_(1, r.slot, w)
    combine = combine[:, :E * C].reshape(T, E, C)
    dispatch = torch.zeros(T, E * C + 1, dtype=torch.bool, device=r.weight.device)
    dispatch.scatter_(1, r.slot, r.kept)
    return combine, dispatch[:, :E * C].reshape(T, E, C)


class _Dispatch(torch.autograd.Function):
    """``[T, d]`` tokens -> ``[E * C, d]`` slot rows: kept (token, slot)
    pairs copied in, empty slots zero.  Backward: a token's gradient is its
    ``k`` slot rows' gradients, gathered and summed in slot order (in fp32
    at least)."""

    @staticmethod
    def forward(ctx, x, slot, n_slots):
        T, d = x.shape
        k = slot.shape[1]
        out = x.new_zeros(n_slots + 1, d)      # row n_slots takes every dropped pair
        out.index_copy_(0, slot.reshape(-1), x[:, None, :].expand(T, k, d).reshape(T * k, d))
        ctx.save_for_backward(slot)
        return out[:n_slots]

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(1, g.shape[1])])
        acc = torch.promote_types(g.dtype, torch.float32)
        dx = g[slot[:, 0]].to(acc)
        for s in range(1, slot.shape[1]):
            dx = dx + g[slot[:, s]].to(acc)
        return dx.to(g.dtype), None, None


def dispatch(tokens: torch.Tensor, r: Routing) -> torch.Tensor:
    """``expert_in`` ``[E, C, d]`` of ``tokens`` ``[T, d]`` under ``r``."""
    E, C = r.num_experts, r.capacity
    return _Dispatch.apply(tokens, r.slot, E * C).reshape(E, C, tokens.shape[1])


def combine(expert_out: torch.Tensor, r: Routing) -> torch.Tensor:
    """``[T, d]``: each token's kept slot rows of ``expert_out`` ``[E, C,
    d]`` times its weights rounded to ``expert_out``'s dtype, summed over the
    slots in fp32 (at least) and rounded once.  A slot's rows are an
    ``index_select``, whose backward adds each token's gradient into its
    kept row, the only one there (the dropped pairs all add into the spare
    row, which is thrown away)."""
    E, C, d = expert_out.shape
    acc = torch.promote_types(expert_out.dtype, torch.float32)
    rows = torch.cat([expert_out.reshape(E * C, d), expert_out.new_zeros(1, d)])
    w = torch.where(r.kept, r.weight, 0.0).to(expert_out.dtype).to(acc)
    out = None
    for s in range(r.slot.shape[1]):
        term = w[:, s, None] * rows.index_select(0, r.slot[:, s]).to(acc)
        out = term if out is None else out + term
    return out.to(expert_out.dtype)


@contextlib.contextmanager
def _fp32_products(device: torch.device):
    """Full-fp32 matmuls on the card (TF32 off) for the scope, whatever the
    global setting: a last-bit change of a router logit can change a route."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class MoELayer(nn.Module):
    """Mixture-of-Experts FFN block (the JAX ``MoELayer``'s parameters and
    routing): ``gate_weight`` fp32 ``[d, E]``, ``w_gate_up`` ``[E, d, 2 dh]``
    and ``w_down`` ``[E, dh, d]`` in ``dtype``, each N(0, 0.02) from
    ``generator`` (or a new one seeded with ``seed`` on ``device``, which
    defaults to CUDA and raises without a card).
    ``gate``: 'naive' | 'switch' (top-1) | 'gshard' (top-2, second expert
    kept by a draw); the capacity is sized from the effective top-k.
    ``mesh``, ``axis_name`` and ``name`` are accepted for the JAX
    signature only: a mesh (expert parallelism, with the ``axis_name``
    axis) raises NotImplementedError, and nothing reads the other two.

    :meth:`forward_with_aux` returns ``(out, aux_loss)``; :meth:`forward`
    the output alone.  ``last_routing`` holds the last forward's
    :class:`Routing` (detached), ``aux_loss`` its aux loss (in its graph,
    as in the JAX package: ``loss + w * layer.aux_loss`` trains the
    router)."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, gate: str = "gshard", mesh=None,
                 axis_name: str = "ep", dtype=None, name=None, *, device=None,
                 generator: Optional[torch.Generator] = None, seed: int = 0,
                 initializer_range: float = 0.02):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError("paddle_tpu_torch: expert parallelism over a mesh "
                                      "comes with the distributed slice")
        if generator is None:
            device = default_device(device)
            generator = make_generator(seed, device)
        device = generator.device if device is None else torch.device(device)
        self.d_model, self.d_hidden, self.num_experts = d_model, d_hidden, num_experts
        self.top_k = effective_top_k(gate, top_k)
        self.capacity_factor = capacity_factor
        self.gate_type = gate
        self.generator = generator
        dt = to_dtype(dtype or "float32")

        def normal(shape, dtype):
            t = torch.empty(shape, dtype=dtype, device=device)
            return nn.Parameter(t.normal_(0.0, initializer_range, generator=self.generator))

        self.gate_weight = normal([d_model, num_experts], torch.float32)
        self.w_gate_up = normal([num_experts, d_model, 2 * d_hidden], dt)
        self.w_down = normal([num_experts, d_hidden, d_model], dt)
        self.aux_loss = None
        self.last_routing: Optional[Routing] = None

    def _capacity(self, T: int) -> int:
        cap = int(math.ceil(self.capacity_factor * self.top_k * T / self.num_experts))
        return max(cap, 1)

    def draw_uniforms(self, tokens: int) -> Optional[torch.Tensor]:
        """The gshard gate's ``[tokens]`` draws from the layer's generator
        (None for the other gates)."""
        if self.gate_type != "gshard":
            return None
        return torch.rand(tokens, generator=self.generator, device=self.generator.device)

    def route(self, tokens: torch.Tensor, uniforms: Optional[torch.Tensor] = None) -> Routing:
        """Router logits in full fp32 and :func:`top_k_gating` over ``tokens``
        ``[T, d]``."""
        with _fp32_products(tokens.device):
            logits = tokens.to(torch.float32) @ self.gate_weight.to(torch.float32)
        if uniforms is None:
            uniforms = self.draw_uniforms(tokens.shape[0])
        return top_k_gating(logits, self.top_k, self._capacity(tokens.shape[0]),
                            self.gate_type, uniforms)

    def forward_with_aux(self, x: torch.Tensor, uniforms: Optional[torch.Tensor] = None):
        shape = x.shape
        tokens = x.reshape(-1, self.d_model)
        r = self.route(tokens, uniforms)
        expert_in = dispatch(tokens, r)                                     # [E, C, d]
        gu = torch.bmm(expert_in, self.w_gate_up.to(x.dtype))
        gate, up = torch.split(gu, [self.d_hidden, self.d_hidden], dim=-1)
        expert_out = torch.bmm(F.silu(gate) * up, self.w_down.to(x.dtype))
        out = combine(expert_out, r).reshape(shape)
        self.aux_loss = r.aux_loss
        self.last_routing = Routing(*(t.detach() for t in r[:6]), r.capacity, r.num_experts)
        return out, r.aux_loss

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_aux(x)[0]
