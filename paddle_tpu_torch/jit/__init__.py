"""``paddle_tpu_torch.jit``: the training step (port of
``paddle_tpu/jit/__init__.py``'s ``TrainStep``).

JAX compiles forward, backward and the optimizer into one XLA program; the
port runs them eagerly: the loss function under autograd, then the
optimizer's functional update over the parameters, in place.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import to_dtype

__all__ = ["TrainStep"]


class TrainStep:
    """One training step: forward, backward and the optimizer update.

    Usage::

        def loss_fn(model, ids):
            return model.compute_loss(model(ids), ids)

        step = paddle_tpu_torch.jit.TrainStep(model, loss_fn, optimizer)
        loss = step(ids)                      # updates model params in place

    ``grad_dtype`` (e.g. ``"bfloat16"``) casts the gradients before the
    update.  ``accumulate_steps`` > 1: every argument carries a leading
    micro-batch axis of that length; each micro-batch's gradients are summed
    in fp32 (or ``grad_dtype``), divided by k, and one update is applied;
    the returned loss is the micro-batch mean.  The optimizer's
    ``grad_clip`` is applied before the update.

    :meth:`state_dict` / :meth:`set_state_dict` are the resume surface
    (``distributed.fleet.CheckpointManager`` saves and loads through them),
    with the JAX ``TrainStep``'s flat keys.

    Not yet ported (they raise ``NotImplementedError``): ``grads_fn`` /
    ``host_grads`` (pipeline schedules) and ``remat`` policies (use
    ``LlamaConfig.recompute``).  ``donate`` is accepted for the JAX
    signature; updates are in place.
    """

    def __init__(self, model, loss_fn, optimizer, donate: bool = True, grads_fn=None,
                 grad_dtype=None, accumulate_steps: int = 1, remat=None,
                 host_grads: bool = False):
        accumulate_steps = int(accumulate_steps)
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
        if grads_fn is not None or host_grads:
            raise NotImplementedError("paddle_tpu_torch: grads_fn / host_grads come with "
                                      "the pipeline slice")
        if remat not in (None, "off"):
            raise NotImplementedError("paddle_tpu_torch: TrainStep remat policies come "
                                      "later; use LlamaConfig.recompute")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accumulate_steps = accumulate_steps
        self.grad_dtype = None if grad_dtype is None else to_dtype(grad_dtype)
        self._params = dict(model.named_parameters())
        init_fn, self._update_fn = optimizer.functional()
        self._opt_state = init_fn(self._params)
        self._step = 0

    def _grads(self, args):
        loss = self.loss_fn(self.model, *args)
        params = list(self._params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def __call__(self, *args):
        device = next(iter(self._params.values())).device
        args = tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a
                     for a in args)
        self._step += 1
        lr = self.optimizer.get_lr()
        k = self.accumulate_steps
        if k > 1:
            acc_dt = self.grad_dtype or torch.float32
            loss_sum = torch.zeros((), dtype=torch.float32, device=device)
            acc = None
            for i in range(k):
                mloss, mgrads = self._grads(tuple(a[i] for a in args))
                mgrads = [g.to(acc_dt) for g in mgrads]
                acc = mgrads if acc is None else [a + g for a, g in zip(acc, mgrads)]
                loss_sum = loss_sum + mloss.to(torch.float32)
            inv = 1.0 / k
            grads = [g * torch.tensor(inv, dtype=g.dtype) for g in acc]
            loss = loss_sum * inv
        else:
            loss, grads = self._grads(args)
            if self.grad_dtype is not None:
                grads = [g.to(self.grad_dtype) for g in grads]
        clip = self.optimizer._grad_clip
        if clip is not None:
            grads = [g for _, g in clip([(None, g) for g in grads])]
        self._update_fn(self._params, dict(zip(self._params, grads)), self._opt_state,
                        lr, self._step)
        return loss

    # -- checkpoint/resume surface (used by fleet.CheckpointManager) --------

    def state_dict(self):
        """Flat dict of everything a resume needs, keyed as the JAX
        ``TrainStep.state_dict``: ``param.<name>``; every optimizer slot as
        ``opt['<name>']['<slot>']`` (``jax.tree_util.keystr``'s form of its
        path, so a positional shift can never load one layer's moments into
        another); ``step``; the LR scheduler's numeric fields as
        ``lr_sched.<field>``.  Values are the live tensors on the step's
        device (the scheduler's and the step counter's new 0-d ones; floats
        in float64, so a resume reproduces the schedule's every bit)."""
        from ..optimizer.lr import LRScheduler

        device = next(iter(self._params.values())).device
        flat = {f"param.{n}": p.detach() for n, p in self._params.items()}
        for n, slots in self._opt_state.items():
            for k, t in slots.items():
                flat[f"opt{_keystr(n, k)}"] = t
        flat["step"] = torch.tensor(self._step, dtype=torch.int32, device=device)
        if isinstance(self.optimizer._lr, LRScheduler):
            for k, v in self.optimizer._lr.state_dict().items():
                if isinstance(v, (bool, int, float)):
                    dt = (torch.bool if isinstance(v, bool) else
                          torch.int64 if isinstance(v, int) else torch.float64)
                    flat[f"lr_sched.{k}"] = torch.tensor(v, dtype=dt, device=device)
        return flat

    @torch.no_grad()
    def set_state_dict(self, flat):
        """Load :meth:`state_dict`'s layout (also one the JAX ``TrainStep``
        wrote): params and slots are copied IN PLACE, each in its own dtype,
        so the optimizer's kernel table stays valid; a missing key or a
        shape that differs raises before anything is written."""
        from ..optimizer.lr import LRScheduler

        pairs = [(p, flat[f"param.{n}"]) for n, p in self._params.items()]
        pairs += [(t, flat[f"opt{_keystr(n, k)}"]) for n, slots in self._opt_state.items()
                  for k, t in slots.items()]
        for dst, src in pairs:
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"state_dict: shape {tuple(src.shape)} != {tuple(dst.shape)}")
        for dst, src in pairs:
            dst.copy_(torch.as_tensor(np.asarray(src)) if not isinstance(src, torch.Tensor)
                      else src)
        self._step = int(flat["step"])
        if isinstance(self.optimizer._lr, LRScheduler):
            sched = self.optimizer._lr
            for k, cur in sched.state_dict().items():
                fk = f"lr_sched.{k}"
                if fk in flat and isinstance(cur, (bool, int, float)):
                    sched.__dict__[k] = type(cur)(flat[fk].item() if hasattr(flat[fk], "item")
                                                  else flat[fk])


def _keystr(name: str, slot: str) -> str:
    """``jax.tree_util.keystr`` of the path ``(name, slot)`` through a dict
    of dicts."""
    return f"[{name!r}][{slot!r}]"
