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

    Not yet ported (they raise ``NotImplementedError``): ``grads_fn`` /
    ``host_grads`` (pipeline schedules) and ``remat`` policies (use
    ``LlamaConfig.recompute``).  ``state_dict`` is not ported either;
    ``models.convert`` exchanges the optimizer state by parameter name.
    ``donate`` is accepted for the JAX signature; updates are in place.
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
