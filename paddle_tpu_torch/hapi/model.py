"""hapi Model: the Keras-like train / evaluate / predict driver.

The port of ``paddle_tpu/hapi/model.py``: ``Model`` with ``prepare``,
``fit``, ``evaluate``, ``predict``, ``train_batch``, ``save`` and
``load``, on the dygraph path (the optimizer's update is its cached
micro-program, replayed as a CUDA graph on the card).

``Model(network, device=None)`` runs where the network's parameters
live, or on ``device`` if given (None and no parameters: the card);
every loop enters a dygraph guard on that device. ``fit(resume_from=)``
needs the training ``CheckpointManager`` (ROADMAP A9) and raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from .. import dygraph
from ..dygraph import to_variable
from ..metric import Metric
from ..reader import DataLoader, Dataset
from .callbacks import Callback, CallbackList, ProgBarLogger, TelemetryLogger

__all__ = ["Model"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _device_of(network, device):
    if device is not None:
        from ..dygraph.tracer import resolve_device

        return resolve_device(device)
    for p in network.parameters():
        return p._tensor.device
    from ..dygraph.tracer import resolve_device

    return resolve_device(None)


class Model:
    def __init__(self, network, inputs=None, labels=None, device=None):
        self.network = network
        self.device = _device_of(network, device)
        self._inputs = _as_list(inputs)
        self._labels = _as_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    # -- setup ----------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None):
        self._optimizer = optimizer
        self._loss = loss
        metrics = _as_list(metrics)
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be Metric instances, got {m}")
        self._metrics = metrics
        return self

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        """Per-layer table (reference: hapi/model.py Model.summary) —
        input_size defaults to the shapes of the Model's input specs."""
        from .model_summary import summary as _summary

        if input_size is None:
            shapes = [tuple(getattr(i, "shape", ())) for i in self._inputs]
            if not shapes or not all(shapes):
                raise ValueError(
                    "summary needs input_size (the Model was built "
                    "without input specs carrying shapes)")
            input_size = shapes
        return _summary(self.network, input_size, dtypes=dtype)

    # -- one-batch ops --------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        return self._loss(*_as_list(outputs), *_as_list(labels))

    def train_batch(self, inputs, labels=None, sync: bool = True):
        """One optimizer step. sync=False leaves the loss on the device
        (no device-to-host wait; the callbacks read it at their log
        cadence). Metrics accumulate on the host, so metrics read their
        batch every step regardless."""
        if self._loss is None or self._optimizer is None:
            raise RuntimeError("call prepare(optimizer, loss) before training")
        self.network.train()
        ins = [to_variable(v) for v in _as_list(inputs)]
        lbls = [to_variable(v) for v in _as_list(labels)]
        outputs = self.network(*ins)
        loss = self._compute_loss(outputs, lbls)
        loss.backward()
        self._optimizer.minimize(loss)
        self.network.clear_gradients()
        metrics = []
        for m in self._metrics:
            m.update(*_as_list(outputs), *lbls)
            metrics.append(m.accumulate())
        loss_out = loss._tensor.detach() if not sync else \
            float(np.asarray(loss.numpy()).reshape(-1)[0])
        return ([loss_out], metrics) if metrics else [loss_out]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with dygraph.no_grad():
            ins = [to_variable(v) for v in _as_list(inputs)]
            lbls = [to_variable(v) for v in _as_list(labels)]
            outputs = self.network(*ins)
            losses = []
            if self._loss is not None and lbls:
                loss = self._compute_loss(outputs, lbls)
                losses = [float(np.asarray(loss.numpy()).reshape(-1)[0])]
            metrics = []
            for m in self._metrics:
                m.update(*_as_list(outputs), *lbls)
                metrics.append(m.accumulate())
        return (losses, metrics) if metrics else losses

    def predict_batch(self, inputs):
        self.network.eval()
        with dygraph.no_grad():
            ins = [to_variable(v) for v in _as_list(inputs)]
            outputs = self.network(*ins)
        return [o.numpy() for o in _as_list(outputs)]

    # -- loops ----------------------------------------------------------------
    def _make_loader(self, data, batch_size, shuffle):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle)
        return data  # assume iterable of batches

    def _split_batch(self, batch):
        batch = _as_list(batch)
        n_in = max(len(self._inputs), 1) if self._inputs else len(batch) - 1
        if len(batch) == 1:
            return batch, []
        return batch[:n_in], batch[n_in:]

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0, callbacks: Optional[List[Callback]] = None,
            resume_from: Optional[str] = None):
        """Train for ``epochs`` over ``train_data`` (a Dataset, a
        DataLoader or an iterable of batches), evaluating on ``eval_data``
        every ``eval_freq`` epochs. ``resume_from`` (crash-consistent
        snapshots) needs ROADMAP A9 and raises."""
        if resume_from:
            raise NotImplementedError(
                "fit(resume_from=...) needs the training CheckpointManager, "
                "which is not in the port yet (ROADMAP A9)")
        loader = self._make_loader(train_data, batch_size, shuffle)
        # the loss crosses to the host only on log steps (every log_freq
        # batches); metrics read every batch anyway. With
        # FLAGS_exec_steps_per_dispatch=k the cadence aligns to k steps
        from ..core.flags import flag as _flag

        k = max(1, int(_flag("exec_steps_per_dispatch")))
        sync_every = max(1, int(log_freq or 1), k)
        force_sync = bool(self._metrics)
        cbks = list(callbacks or [])
        if verbose and not any(isinstance(c, ProgBarLogger) for c in cbks):
            cbks.append(ProgBarLogger(log_freq, verbose=verbose))
        if save_dir:
            from .callbacks import ModelCheckpoint

            cbks.append(ModelCheckpoint(save_freq, save_dir))
        from ..core import telemetry

        if telemetry.enabled() and \
                not any(isinstance(c, TelemetryLogger) for c in cbks):
            # scalar step events only on the steps that read the loss
            cbks.append(TelemetryLogger(every=sync_every))
        steps = len(loader) if hasattr(loader, "__len__") else None
        cb = CallbackList(cbks, model=self,
                          params={"epochs": epochs, "steps": steps,
                                  "verbose": verbose, "save_dir": save_dir,
                                  "metrics": self._metrics_names()})
        self.stop_training = False
        with dygraph.guard(self.device):
            cb.on_train_begin()
            logs: Dict[str, Any] = {}
            for epoch in range(epochs):
                cb.on_epoch_begin(epoch)
                for m in self._metrics:
                    m.reset()
                for step, batch in enumerate(loader):
                    cb.on_train_batch_begin(step)
                    ins, lbls = self._split_batch(batch)
                    result = self.train_batch(
                        ins, lbls,
                        sync=force_sync or step % sync_every == 0)
                    logs = self._result_logs(result)
                    cb.on_train_batch_end(step, logs)
                cb.on_epoch_end(epoch, logs)
                if eval_data is not None and epoch % eval_freq == 0:
                    self.evaluate(eval_data, batch_size=batch_size,
                                  verbose=verbose, callbacks=cbks,
                                  num_workers=num_workers)
                if self.stop_training:
                    break
            cb.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0,
                 callbacks: Optional[List[Callback]] = None):
        loader = self._make_loader(eval_data, batch_size, shuffle=False)
        cb = CallbackList(list(callbacks or []), model=self)
        with dygraph.guard(self.device):
            cb.on_eval_begin()
            for m in self._metrics:
                m.reset()
            logs: Dict[str, Any] = {}
            losses = []
            for step, batch in enumerate(loader):
                cb.on_eval_batch_begin(step)
                ins, lbls = self._split_batch(batch)
                result = self.eval_batch(ins, lbls)
                logs = self._result_logs(result, prefix="eval_")
                if isinstance(result, tuple):
                    losses.extend(result[0])
                else:
                    losses.extend(result)
                cb.on_eval_batch_end(step, logs)
            if losses:
                logs["eval_loss"] = float(np.mean(losses))
            cb.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size: int = 1,
                stack_outputs: bool = False):
        loader = self._make_loader(test_data, batch_size, shuffle=False)
        outs: List[List[np.ndarray]] = []
        with dygraph.guard(self.device):
            for batch in loader:
                ins, _ = self._split_batch(batch)
                outs.append(self.predict_batch(ins))
        n_out = len(outs[0]) if outs else 0
        grouped = [[b[i] for b in outs] for i in range(n_out)]
        if stack_outputs:
            grouped = [np.concatenate(g, axis=0) for g in grouped]
        return grouped

    # -- persistence ----------------------------------------------------------
    def save(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        dygraph.save_dygraph(self.network.state_dict(), path)
        if self._optimizer is not None and hasattr(self._optimizer,
                                                   "state_dict"):
            dygraph.save_dygraph(self._optimizer.state_dict(), path)

    def load(self, path: str, skip_mismatch: bool = False,
             reset_optimizer: bool = False):
        params, opt_state = dygraph.load_dygraph(path)
        if params is not None:
            self.network.set_state_dict(params)
        if not reset_optimizer and opt_state and self._optimizer is not None \
                and hasattr(self._optimizer, "set_state_dict"):
            self._optimizer.set_state_dict(opt_state)
        return self

    # -- helpers --------------------------------------------------------------
    def _metrics_names(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def _result_logs(self, result, prefix=""):
        logs: Dict[str, Any] = {}
        if isinstance(result, tuple):
            losses, metrics = result
            logs[prefix + "loss"] = losses[0] if losses else None
            for m, v in zip(self._metrics, metrics):
                n = m.name()
                if isinstance(n, list):
                    for ni, vi in zip(n, _as_list(v)):
                        logs[prefix + ni] = vi
                else:
                    logs[prefix + n] = v
        else:
            logs[prefix + "loss"] = result[0] if result else None
        return logs
