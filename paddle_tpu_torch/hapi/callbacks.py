"""hapi callbacks (port of ``paddle_tpu/hapi/callbacks.py``).

The hooks and their arguments are the JAX package's.  One difference: the
port's ``Model.evaluate`` fires ``on_eval_begin`` / ``on_eval_end`` (with
the evaluation's logs), as Paddle's ``hapi/model.py`` does, so
:class:`ReduceLROnPlateau` and :class:`VisualDL`'s eval scalars act on the
evaluations inside ``fit``; the JAX ``Model`` never fires them.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRSchedulerCallback", "ReduceLROnPlateau", "VisualDL", "WandbCallback"]


class Callback:
    """Base callback: hooks around fit/epoch/batch (reference ``Callback``)."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params)

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model, params):
        self.callbacks = list(callbacks)
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def call(self, hook, *args, **kwargs):
        for c in self.callbacks:
            getattr(c, hook)(*args, **kwargs)


class ProgBarLogger(Callback):
    """Per-epoch textual progress (role of the reference's ProgBarLogger)."""

    def __init__(self, log_freq: int = 10, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()
        if self.verbose:
            print(f"Epoch {epoch + 1}/{self.params.get('epochs', '?')}", file=sys.stderr)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and (step + 1) % self.log_freq == 0:
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                               if isinstance(v, float))
            print(f"  step {step + 1}/{self.params.get('steps', '?')} - {items}",
                  file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = " - ".join(f"{k}: {v:.4f}" for k, v in (logs or {}).items()
                               if isinstance(v, float))
            print(f"  epoch done in {dt:.1f}s - {items}", file=sys.stderr)


class ModelCheckpoint(Callback):
    """Save every ``save_freq`` epochs into ``save_dir`` (reference semantics:
    ``<dir>/<epoch>`` prefix + a ``final`` save at train end)."""

    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stop when ``monitor`` stops improving (reference EarlyStopping)."""

    def __init__(self, monitor: str = "loss", mode: str = "min", patience: int = 0,
                 min_delta: float = 0.0, baseline=None, save_best_model: bool = False):
        super().__init__()
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.wait = 0
        self.best = baseline  # an epoch only counts if it beats the baseline
        self.stopped_epoch = None

    def _better(self, cur, ref):
        if self.mode == "max":
            return cur > ref + self.min_delta
        return cur < ref - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model:
                save_dir = self.params.get("save_dir")
                if save_dir:
                    self.model.save(os.path.join(save_dir, "best_model"))
            return
        self.wait += 1
        if self.wait > self.patience:
            self.stopped_epoch = epoch
            self.model.stop_training = True


class LRSchedulerCallback(Callback):
    """Step an LR scheduler once per epoch (reference LRScheduler callback)."""

    def __init__(self, by_step: bool = False):
        super().__init__()
        self.by_step = by_step

    def _sched(self):
        from ..optimizer.lr import LRScheduler

        lr = getattr(self.model._optimizer, "_lr", None)
        return lr if isinstance(lr, LRScheduler) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step and (s := self._sched()) is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        if not self.by_step and (s := self._sched()) is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    """Reduce the optimizer LR when a monitored metric plateaus (reference
    ``callbacks.py`` ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="min", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        self._best = None
        self._wait = 0
        self._cool = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        val = logs.get(self.monitor)
        if val is None:
            return
        val = float(val[0] if isinstance(val, (list, tuple)) else val)
        better = (self._best is None
                  or (self.mode == "min" and val < self._best - self.min_delta)
                  or (self.mode == "max" and val > self._best + self.min_delta))
        if better:
            self._best = val
            self._wait = 0
            return
        if self._cool > 0:
            self._cool -= 1
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                new_lr = max(float(opt.get_lr()) * self.factor, self.min_lr)
                opt.set_lr(new_lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}")
            self._wait = 0
            self._cool = self.cooldown


class VisualDL(Callback):
    """Scalar logging callback (reference VisualDL callback).  The visualdl
    wheel is not a dependency; scalars land in a JSONL file under
    ``log_dir`` readable by any dashboard."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._step = 0

    def _write(self, tag, logs):
        import json

        logs = logs or {}
        path = os.path.join(self.log_dir, "scalars.jsonl")
        with open(path, "a") as f:
            for k, v in logs.items():
                try:
                    val = float(v[0] if isinstance(v, (list, tuple)) else v)
                except (TypeError, ValueError):
                    continue
                f.write(json.dumps({"tag": f"{tag}/{k}", "step": self._step,
                                    "value": val}) + "\n")

    def on_epoch_end(self, epoch, logs=None):
        self._step = epoch
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


class WandbCallback(Callback):
    """Weights & Biases logging (reference WandbCallback): needs the wandb
    package; without it constructing raises ``ImportError``, as the JAX
    package's."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        try:
            import wandb  # noqa: F401
        except ImportError:
            raise ImportError("WandbCallback needs the wandb package, which is "
                              "not installed in this environment") from None
        raise NotImplementedError("paddle_tpu_torch: WandbCallback logging is not ported")
