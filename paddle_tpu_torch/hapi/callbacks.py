"""hapi callbacks (port of ``paddle_tpu/hapi/callbacks.py``):
ProgBarLogger, ModelCheckpoint, EarlyStopping and TelemetryLogger, which
writes ``hapi.step_ms`` (a timer) and ``hapi.train_steps`` (a counter)
to the port's telemetry (``core/telemetry.py``) and its JSONL run log."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "CallbackList", "TelemetryLogger"]


def _scalar(v):
    """The first element of a log value: a number, an array, a list or a
    tensor left on the device (read here, at the log cadence)."""
    import torch

    if isinstance(v, torch.Tensor):
        return v.reshape(-1)[0].item()
    return np.asarray(v).reshape(-1)[0]


class Callback:
    def __init__(self):
        self.model = None
        self.params: Dict = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params: Dict):
        self.params = dict(params or {})

    # lifecycle hooks — mode in {train, eval, predict}
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None, model=None,
                 params=None):
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            cb.set_model(model)
            if params is not None:  # don't wipe params set by an outer loop
                cb.set_params(params)

    def _call(self, name, *args, **kw):
        for cb in self.callbacks:
            getattr(cb, name)(*args, **kw)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: self._call(name, *a, **k)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-epoch progress logging (reference: callbacks.py ProgBarLogger)."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose < 2 or step % self.log_freq:
            return
        logs = logs or {}
        items = " - ".join(f"{k}: {self._fmt(v)}" for k, v in logs.items())
        total = f"/{self.steps}" if self.steps else ""
        print(f"Epoch {self.epoch}: step {step}{total} - {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose < 1:
            return
        logs = logs or {}
        items = " - ".join(f"{k}: {self._fmt(v)}" for k, v in logs.items())
        dt = time.time() - self._start
        print(f"Epoch {epoch} done ({dt:.1f}s) - {items}")

    def on_eval_end(self, logs=None):
        if self.verbose < 1:
            return
        logs = logs or {}
        items = " - ".join(f"{k}: {self._fmt(v)}" for k, v in logs.items())
        print(f"Eval - {items}")

    @staticmethod
    def _fmt(v):
        try:
            return f"{float(_scalar(v)):.4f}"
        except (TypeError, ValueError):
            return str(v)


class TelemetryLogger(Callback):
    """Stream step-level training metrics into ``core.telemetry``: per-step
    wall time (the ``hapi.step_ms`` histogram → step-time percentiles in
    ``tools/perf_report.py``), steps/s throughput, and the scalar logs
    (loss/metrics) as JSONL ``step`` events when a run log is enabled
    (``FLAGS_telemetry_path`` / ``PT_TELEMETRY_LOG``). ``Model.fit``
    attaches one automatically whenever the sink is enabled."""

    def __init__(self, every: int = 1):
        super().__init__()
        self.every = max(1, int(every))
        self._t0 = None
        self._epoch = 0

    @staticmethod
    def _scalars(logs):
        out = {}
        for k, v in (logs or {}).items():
            try:
                out[k] = float(_scalar(v))
            except (TypeError, ValueError):
                pass
        return out

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        from ..core import telemetry

        if self._t0 is None:
            return
        ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        telemetry.observe("hapi.step_ms", ms, kind="timer")
        telemetry.counter_add("hapi.train_steps", 1)
        if step % self.every:
            return
        attrs = {"epoch": self._epoch, "step": int(step),
                 "ms": round(ms, 3)}
        if ms > 0:
            attrs["steps_per_s"] = round(1e3 / ms, 3)
        attrs.update(self._scalars(logs))
        telemetry.event("step", "train", attrs.get("loss"), attrs)

    def on_eval_end(self, logs=None):
        from ..core import telemetry

        attrs = self._scalars(logs)
        telemetry.counter_add("hapi.evals", 1)
        telemetry.event("step", "eval",
                        attrs.get("eval_loss", attrs.get("loss")), attrs)


class ModelCheckpoint(Callback):
    """Save params (+opt state) every `save_freq` epochs into
    `save_dir/{epoch}` and `save_dir/final` (reference: ModelCheckpoint),
    through dygraph.save_dygraph, whose npz + manifest files commit
    atomically."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))

    def on_train_end(self, logs=None):
        if self.model:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, min_delta: float = 0.0,
                 baseline: Optional[float] = None,
                 save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def _improved(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        # eval logs are 'eval_'-prefixed; accept the bare reference-style
        # monitor name ('loss', 'acc') as well
        key = self.monitor if self.monitor in logs else "eval_" + self.monitor
        if key not in logs:
            return
        cur = float(_scalar(logs[key]))
        if self._improved(cur):
            self.best = cur
            self.wait = 0
            save_dir = self.params.get("save_dir")
            if self.save_best_model and self.model is not None and save_dir:
                self.model.save(os.path.join(save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True
