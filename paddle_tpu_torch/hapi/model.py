"""hapi ``Model``: fit / evaluate / predict over ``jit.TrainStep`` (port of
``paddle_tpu/hapi/model.py``).

The JAX ``Model`` compiles its training step and a cached eval forward
with ``jax.jit``; the port's training step is the port's ``TrainStep``
(forward, backward and the optimizer update, eager, on the network's
device) and its eval forward runs the network in eval mode under
``torch.no_grad()``.  A batch is unwrapped (port ``Tensor`` -> torch, a
host array -> torch) and moved to the network's device once a step.

Where the two differ: ``evaluate`` fires the callbacks' ``on_eval_begin``
/ ``on_eval_end`` (also for the evaluations inside ``fit``), as Paddle's
``hapi/model.py`` does and the JAX ``Model`` does not; ``summary`` counts
a parameter as trainable by ``requires_grad`` (the port's parameters are
``torch.nn.Parameter``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..framework.device import default_device
from ..framework.tensor import Tensor, wrap
from ..io import DataLoader, Dataset
from ..jit import TrainStep
from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model", "summary"]


def _to_loader(data, batch_size, shuffle, drop_last=False, num_workers=0):
    if data is None or isinstance(data, DataLoader):
        return data
    if isinstance(data, Dataset):
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)
    raise TypeError(f"expected Dataset or DataLoader, got {type(data)}")


def _split_batch(batch, n_inputs):
    if isinstance(batch, (list, tuple)):
        return tuple(batch[:n_inputs]), tuple(batch[n_inputs:])
    return (batch,), ()


def _as_tuple(v):
    if v is None:
        return ()
    return tuple(v) if isinstance(v, (list, tuple)) else (v,)


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _on(x, device: torch.device) -> torch.Tensor:
    """One batch leaf as a torch tensor on ``device``."""
    if isinstance(x, Tensor):
        x = x._data
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device, non_blocking=True)


class Model:
    """High-level training / eval / inference wrapper around an ``nn.Layer``::

        model = hapi.Model(network)
        model.prepare(optimizer, paddle.nn.CrossEntropyLoss(), metric.Accuracy())
        model.fit(train_dataset, epochs=2, batch_size=32)
        model.evaluate(val_dataset)
        model.predict(test_dataset)
    """

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs_spec = inputs if inputs is None or isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._labels_spec = labels if labels is None or isinstance(labels, (list, tuple)) \
            else [labels]
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self.stop_training = False

    # -- setup --------------------------------------------------------------

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m!r} is not a paddle_tpu_torch.metric.Metric")
        self._train_step = None  # rebuilt lazily (the optimizer may have changed)
        return self

    def _device(self) -> torch.device:
        p = next(self.network.parameters(), None)
        return p.device if p is not None else default_device()

    def _loss_value(self, outputs, labels):
        loss = self._loss(outputs, *labels)
        if isinstance(loss, (list, tuple)):
            loss = sum(loss[1:], loss[0])
        return loss

    def _build_train_step(self, n_inputs):
        def loss_fn(net, *batch):
            ins, labels = batch[:n_inputs], batch[n_inputs:]
            return self._loss_value(net(*ins), labels)

        return TrainStep(self.network, loss_fn, self._optimizer)

    def _forward_eval(self, ins):
        """The network in eval mode (dropout off, BatchNorm's running
        statistics) under no_grad; its mode is restored after."""
        net = self.network
        was_training = net.training
        net.eval()
        try:
            with torch.no_grad():
                return net(*ins)
        finally:
            if was_training:
                net.train()

    # -- batch-level API (reference train_batch / eval_batch / predict_batch) --

    def train_batch(self, inputs, labels=None):
        dev = self._device()
        ins = tuple(_on(x, dev) for x in _as_tuple(inputs))
        labels = tuple(_on(y, dev) for y in _as_tuple(labels))
        self.network.train()
        if self._train_step is None:
            self._train_step = self._build_train_step(len(ins))
        return float(self._train_step(*ins, *labels))

    def eval_batch(self, inputs, labels=None):
        dev = self._device()
        ins = tuple(_on(x, dev) for x in _as_tuple(inputs))
        labels = tuple(_on(y, dev) for y in _as_tuple(labels))
        outputs = self._forward_eval(ins)
        loss = self._loss_value(outputs, labels) if self._loss is not None else None
        for m in self._metrics:
            m.update(*_as_list(m.compute(outputs, *labels)))
        return float(loss) if loss is not None else None

    def predict_batch(self, inputs):
        dev = self._device()
        return wrap(self._forward_eval(tuple(_on(x, dev) for x in _as_tuple(inputs))))

    # -- loops --------------------------------------------------------------

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before fit()")
        # accumulate_grad_batches: k consecutive batches concatenated on the
        # device and ONE step run, as the JAX package does (for a mean loss
        # the same update as k accumulated steps)
        acc = max(1, int(accumulate_grad_batches))
        loader = _to_loader(train_data, batch_size, shuffle, drop_last, num_workers)
        eval_loader = _to_loader(eval_data, batch_size, False)
        cbs = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbs):
            cbs.insert(0, ProgBarLogger(log_freq, verbose))
        if save_dir is not None:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        try:
            steps = (len(loader) + acc - 1) // acc
        except TypeError:
            steps = None
        cblist = CallbackList(cbs, self, {"epochs": epochs, "steps": steps,
                                          "verbose": verbose, "save_dir": save_dir})
        self.stop_training = False
        history = {"loss": []}
        cblist.call("on_train_begin")
        it_count = 0
        dev = self._device()

        def _accumulated(it):
            """Batches, groups of ``acc`` concatenated along axis 0."""
            if acc == 1:
                yield from it
                return
            group = []
            for b in it:
                group.append(b)
                if len(group) == acc:
                    yield [torch.cat([_on(g[i], dev) for g in group])
                           for i in range(len(group[0]))]
                    group = []
            if group:
                yield [torch.cat([_on(g[i], dev) for g in group])
                       for i in range(len(group[0]))]

        for epoch in range(epochs):
            cblist.call("on_epoch_begin", epoch)
            epoch_losses = []
            for step, batch in enumerate(_accumulated(loader)):
                cblist.call("on_train_batch_begin", step)
                ins, labels = _split_batch(batch, self._n_inputs(batch))
                loss = self.train_batch(ins, labels)
                epoch_losses.append(loss)
                cblist.call("on_train_batch_end", step, {"loss": loss})
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    self.stop_training = True
                    break
            logs = {"loss": float(np.mean(epoch_losses)) if epoch_losses else float("nan")}
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self._evaluate(eval_loader, cblist)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            history["loss"].append(logs["loss"])
            cblist.call("on_epoch_end", epoch, logs)
            if self.stop_training:
                break
        cblist.call("on_train_end", {"loss": history["loss"]})
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = _to_loader(eval_data, batch_size, False, num_workers=num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cblist = CallbackList(list(callbacks or []), self,
                              {"steps": steps, "verbose": verbose})
        return self._evaluate(loader, cblist, num_samples)

    def _evaluate(self, loader, cblist, num_samples=None):
        for m in self._metrics:
            m.reset()
        cblist.call("on_eval_begin")
        losses = []
        seen = 0
        for batch in loader:
            ins, labels = _split_batch(batch, self._n_inputs(batch))
            loss = self.eval_batch(ins, labels)
            if loss is not None:
                losses.append(loss)
            seen += int(ins[0].shape[0])
            if num_samples is not None and seen >= num_samples:
                break
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), (list, tuple)) else [m.name()]
            vals = res if isinstance(res, (list, tuple)) else [res]
            for n, v in zip(names, vals):
                logs[n] = float(v)
        cblist.call("on_eval_end", logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        loader = _to_loader(test_data, batch_size, False, num_workers=num_workers)
        outs = []
        for batch in loader:
            ins, _ = _split_batch(batch, self._n_inputs(batch))
            outs.append([t.numpy() for t in _as_list(self.predict_batch(ins))])
        n_out = len(outs[0]) if outs else 0
        grouped = [[b[i] for b in outs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    def _n_inputs(self, batch):
        """Without an ``inputs`` spec, everything but the last batch element
        is input (the (x, label) dataset convention; predict data shaped
        the same way has its labels ignored)."""
        if self._inputs_spec is not None:
            return len(self._inputs_spec)
        if not isinstance(batch, (list, tuple)) or len(batch) <= 1:
            return 1
        return len(batch) - 1

    # -- persistence & introspection ---------------------------------------

    def save(self, path, training=True):
        """``path + ".pdparams"``: ``{"model": state_dict, "optimizer": ...}``
        in the format of ``paddle_tpu_torch.save`` (the JAX package's)."""
        from ..framework.io import save as _save

        state = {"model": self.network.state_dict()}
        if training and self._optimizer is not None:
            state["optimizer"] = self._optimizer.state_dict()
        _save(state, path + ".pdparams")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Read what :meth:`save` (or the JAX ``Model.save``) wrote."""
        from ..framework.io import load as _load

        state = _load(path + ".pdparams")
        self.network.set_state_dict(state["model"])
        if not reset_optimizer and self._optimizer is not None and "optimizer" in state:
            self._optimizer.set_state_dict(state["optimizer"])
        self._train_step = None

    def parameters(self, *args, **kwargs):
        return list(self.network.parameters(*args, **kwargs))

    def summary(self, input_size=None, dtype=None):
        return summary(self.network)


def summary(network, input_size=None, dtypes=None):
    """Parameter-count summary: prints a per-parameter table, returns
    ``{'total_params': N, 'trainable_params': N}`` (trainable: the
    parameters that require grad)."""
    rows = []
    total = 0
    trainable = 0
    for name, p in network.named_parameters():
        n = int(np.prod(tuple(p.shape))) if p.dim() else 1
        total += n
        if p.requires_grad:
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=10) + 2
    print(f"{'Layer (param)':<{width}}{'Shape':<24}{'Params':>12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<24}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total:,}  (trainable: {trainable:,})")
    return {"total_params": total, "trainable_params": trainable}
