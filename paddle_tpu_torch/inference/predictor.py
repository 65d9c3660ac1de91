"""AnalysisPredictor, the user-facing inference engine (port of
``paddle_tpu/inference/predictor.py:29-288``).

load_inference_model -> apply_passes (``DEFAULT_PASSES``, verified after
each one) -> one entry per feed signature (the names, shapes and dtypes
of the feeds). Where the reference jits the block per signature, an
entry here holds static feed buffers and runs the block once op by op,
which does the lazy work (kernel builds, library handles); on the card it
then captures the block into a CUDA graph (``core/graph.py``
``StepGraph``), and every later run of that signature copies the feeds
into the buffers and replays the graph: no op is dispatched from the
host, and the kernel launch counters get the capture's counts added per
replay. The entries of one predictor share one graph memory pool. One
lock (``_RUN_LOCK``) lets one predictor run at a time in a process: a
swap candidate's warm-up (its first runs and graph captures, in the
swapping thread) interleaves with the serving predictor's batches
instead of overlapping them, so no capture meets another thread's
synchronising copy, and each capture's launch counts are its own. An LRU over ``FLAGS_predictor_cache_capacity``
bounds them, with the reference's counters ``predictor.cache_hits`` /
``cache_misses`` / ``cache_evictions`` / ``compiles`` and the
``predictor.cache_size`` gauge.

Parameters go to the device once, at construction; on the card a
static-quant ``int8_matmul``'s weight is laid out column-major there
(``quant_ops.column_major``). The predictor runs on
``cuda:0`` unless ``AnalysisConfig(device=...)`` or ``device=`` asks for
another device (``"cpu"``: the tests, and the card's CPU reference); with
neither and no CUDA it raises.

With cost capture on (``core/costmodel.py``, ``FLAGS_cost_capture``),
each new signature gets a cost record (its flops and bytes from a run
of the block on meta tensors; at level ``full`` on the card, the
allocator's peak around its graph capture), ``_last_cost`` is the
record of the most recent run (the micro-batching engine publishes each
warmed bucket's as ``mem.serving.bucket<B>_peak_bytes``), and the
weights are booked once as the ledger's ``mem.param_bytes``. An
allocation failure in a run raises ``costmodel.OutOfMemoryError`` after
its forensics record.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import io
from ..core import costmodel, registry, telemetry
from ..core.executor import (_feed_spec, _last_readers, _to_numpy,
                             meta_count, run_op)
from ..core.flags import flag as _flag
from ..core.graph import StepGraph
from ..core.ir import Program
from ..core.passes import apply_passes
from ..core.scope import Scope
from ..ops import quant_ops

_RUN_LOCK = threading.Lock()

DEFAULT_PASSES = [
    "delete_dropout_pass",
    "conv_bn_fuse_pass",
    "embedding_eltwise_layernorm_fuse_pass",
    "multihead_attention_fuse_pass",
    "fc_fuse_pass",
    # after fc_fuse: this one would otherwise take the (bias add, act)
    # pair that fc_fuse wants
    "fuse_elewise_add_act_pass",
    # last: sweep the remaining elementwise runs into composite ops
    "fusion_group_pass",
]


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the predictor runs on the GPU by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU")
        device = "cuda:0"
    return torch.device(device)


class AnalysisConfig:
    """reference: ``AnalysisConfig``. ``model_dir`` points at a dir
    written by ``io.save_inference_model``; ``device`` is the predictor's
    (None: cuda:0)."""

    def __init__(self, model_dir: Optional[str] = None,
                 prog_file: Optional[str] = None,
                 params_file: Optional[str] = None, device=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.device = device
        self.ir_optim = True
        self.passes: List[str] = list(DEFAULT_PASSES)
        self._deleted: set = set()

    def set_model(self, model_dir: str, params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.params_file = params_file

    def switch_ir_optim(self, on: bool = True):
        self.ir_optim = bool(on)

    def delete_pass(self, name: str):
        self._deleted.add(name)

    def enabled_passes(self) -> List[str]:
        return [p for p in self.passes if p not in self._deleted]


Config = AnalysisConfig


class PredictorTensor:
    """A ZeroCopyTensor-style handle: ``copy_from_cpu`` stages an input,
    ``copy_to_cpu`` reads an output of the last run."""

    def __init__(self, name: str, owner: "AnalysisPredictor",
                 is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        if not self._is_input:
            raise ValueError(f"'{self.name}' is an output tensor")
        self._owner._staged[self.name] = np.asarray(arr)

    def copy_to_cpu(self):
        if self._is_input:
            return self._owner._staged.get(self.name)
        out = self._owner._last_outputs
        if out is None:
            raise RuntimeError("run() has not been called yet")
        return np.asarray(out[self.name])

    @property
    def shape(self):
        if self._is_input:
            v = self._owner._staged.get(self.name)
            return None if v is None else v.shape
        out = self._owner._last_outputs
        if out is None:
            return None
        v = out.get(self.name)
        return None if v is None else tuple(v.shape)


class _Entry:
    """One feed signature: static feed buffers on the device and the
    block over them, run op by op the first time and replayed from a
    CUDA graph after that (on the CPU, run op by op every time)."""

    def __init__(self, pred: "AnalysisPredictor", sig, pool):
        self.pred = pred
        self.feeds = {n: torch.empty(shape, dtype=getattr(torch, dt),
                                     device=pred.device)
                      for n, shape, dt in sig}
        self.graph = StepGraph(self._step, pred.device, pool=pool)
        self.ran = False
        # allocator statistics around the graph capture (cost level full)
        self.measure_memory = False
        self.capture_memory: Optional[Dict[str, int]] = None

    def _step(self) -> List[torch.Tensor]:
        pred = self.pred
        env: Dict[str, Any] = dict(pred._params)
        env.update(self.feeds)
        with registry.creating_on(pred.device):
            for op, drop in zip(pred._ops, pred._dead):
                run_op(op, env)
                for n in drop:
                    env.pop(n, None)
        return [env[n] for n in pred.fetch_names]

    def __call__(self, feeds: Dict[str, torch.Tensor]) -> List[np.ndarray]:
        for n, buf in self.feeds.items():
            buf.copy_(feeds[n])
        if self.ran:
            return [_to_numpy(o) for o in self.graph.replay()]
        outs = [_to_numpy(o) for o in self._step()]
        self.ran = True
        if self.measure_memory:
            _, self.capture_memory = costmodel.memory_around(
                self.graph.capture, self.pred.device)
        else:
            self.graph.capture()
        return outs

    def meta_cost(self) -> tuple:
        env: Dict[str, Any] = dict(self.pred._params)
        env.update(self.feeds)
        return meta_count(self.pred._ops, self.pred._dead, env)


class AnalysisPredictor:
    def __init__(self, config: AnalysisConfig,
                 program: Optional[Program] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence[str]] = None,
                 scope: Optional[Scope] = None, device=None):
        self.config = config
        self.device = _resolve_device(device if device is not None
                                      else config.device)
        if program is None:
            if not config.model_dir:
                raise ValueError("AnalysisConfig.model_dir not set")
            scope = scope if scope is not None else Scope()
            program, feed_names, fetch_names = io.load_inference_model(
                config.model_dir, model_filename=config.prog_file,
                params_filename=config.params_file, scope=scope)
        self.program = program
        self.scope = scope if scope is not None else Scope()
        self.feed_names = list(feed_names or [])
        self.fetch_names = list(fetch_names or [])
        if config.ir_optim:
            # the feed and fetch names sharpen the check after each pass:
            # a pass that orphans a read or drops a fetch fails here
            self.program = apply_passes(self.program,
                                        config.enabled_passes(),
                                        scope=self.scope,
                                        feed_names=self.feed_names,
                                        fetch_names=self.fetch_names)
        block = self.program.global_block()
        self._ops = list(block.ops)
        persist = {v.name for v in block.vars.values() if v.persistable}
        self._dead = _last_readers(block, persist | set(self.fetch_names))
        self._staged: Dict[str, np.ndarray] = {}
        self._last_outputs: Optional[Dict[str, Any]] = None
        # per-signature cost records (core/costmodel.py); the record of
        # the most recent run
        self._cost_records: Dict[tuple, Any] = {}
        self._last_cost: Any = None
        self._params_booked = False
        self._cache: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        # the parameters go to the device once (a numpy array in the
        # scope as a tensor of its own dtype: an int8 weight stays int8)
        self._params = {n: (v.to(self.device) if isinstance(v, torch.Tensor)
                            else torch.from_numpy(np.array(v)).to(
                                self.device)
                            if isinstance(v, np.ndarray) else v)
                        for n, v in self.scope.items()}
        if self.device.type == "cuda":
            # a static-quant int8_matmul's weight, column-major once: the
            # layout torch._int_mm runs fast (ops/quant_ops.py)
            for op in self._ops:
                if op.type == "int8_matmul" and op.attrs.get("act_scale"):
                    y = op.inputs["Y"][0]
                    self._params[y] = quant_ops.column_major(self._params[y])

    def _entry(self, sig) -> Tuple[_Entry, bool]:
        """(the signature's entry, whether it is new)."""
        entry = self._cache.get(sig)
        if entry is not None:
            self._cache.move_to_end(sig)
            telemetry.counter_add("predictor.cache_hits", 1)
            return entry, False
        telemetry.counter_add("predictor.cache_misses", 1)
        entry = self._cache[sig] = _Entry(self, sig, self._pool)
        cap = int(_flag("predictor_cache_capacity"))
        while cap > 0 and len(self._cache) > cap:
            self._cache.popitem(last=False)
            telemetry.counter_add("predictor.cache_evictions", 1)
        telemetry.gauge_set("predictor.cache_size", len(self._cache))
        return entry, True

    def get_input_names(self) -> List[str]:
        return list(self.feed_names)

    def get_output_names(self) -> List[str]:
        return list(self.fetch_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        if name not in self.feed_names:
            raise KeyError(f"'{name}' is not an input; have {self.feed_names}")
        return PredictorTensor(name, self, is_input=True)

    get_input_tensor = get_input_handle

    def get_output_handle(self, name: str) -> PredictorTensor:
        if name not in self.fetch_names:
            raise KeyError(
                f"'{name}' is not an output; have {self.fetch_names}")
        return PredictorTensor(name, self, is_input=False)

    get_output_tensor = get_output_handle

    def feed_specs(self) -> Dict[str, Tuple[tuple, str]]:
        """{feed name: (static shape with -1 batch dims, dtype)}: the
        model's input signature (the engine's warm-up, HTTP clients)."""
        block = self.program.global_block()
        specs = {}
        for n in self.feed_names:
            if block.has_var(n):
                v = block.var(n)
                specs[n] = (tuple(v.shape or ()), str(v.dtype))
            else:
                specs[n] = ((), "float32")
        return specs

    def run(self, feeds: Optional[Dict[str, Any]] = None
            ) -> List[np.ndarray]:
        """Run the staged handles, updated by the ``feeds`` dict; returns
        the fetches as numpy arrays, in fetch_names order."""
        feed = dict(self._staged)
        if feeds:
            feed.update({k: np.asarray(v) for k, v in feeds.items()})
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        block = self.program.global_block()
        host = {}
        for n in self.feed_names:
            t, dt = _feed_spec(block, n, feed[n])
            host[n] = t.to(dt)
        sig = tuple((n, tuple(host[n].shape), str(host[n].dtype)[6:])
                    for n in self.feed_names)
        capture = costmodel.capture_mode()
        with _RUN_LOCK:
            entry, is_new = self._entry(sig)
            if is_new:
                entry.measure_memory = self.device.type == "cuda" and \
                    capture == "full"
            t0 = time.perf_counter()
            try:
                outs = entry(host)
            except torch.OutOfMemoryError as e:
                raise costmodel.oom_forensics(
                    f"predictor{list(sig)}"[:200], e,
                    where="predictor.run") from e
        if is_new and capture != "off":
            rows = sig[0][1][0] if sig and sig[0][1] else 0
            mem = entry.capture_memory
            if mem is not None:
                mem = dict(mem, out_bytes=sum(o.nbytes for o in outs))
            self._cost_records[sig] = costmodel.capture(
                entry.meta_cost, key_id=costmodel.key_id_for(sig),
                kind="predictor", program=f"rows{rows}",
                device=self.device, memory=mem)
            if not self._params_booked:
                # the frozen weights are this process's parameters
                self._params_booked = True
                costmodel.record_model_bytes(
                    sum(costmodel._nbytes(v)
                        for v in self._params.values()), 0)
        self._last_cost = self._cost_records.get(sig)
        if is_new:
            # as in the executor, the compile time is the first run's
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            telemetry.counter_add("predictor.compiles", 1)
            telemetry.event("compile", "predictor", ms,
                            {"cause": "feed_signature",
                             "cache_size": len(self._cache),
                             "feed_names": [s[0] for s in sig],
                             "fetch_names": list(self.fetch_names)})
        self._last_outputs = dict(zip(self.fetch_names, outs))
        return outs


def create_predictor(config: AnalysisConfig,
                     device=None) -> AnalysisPredictor:
    """reference: ``create_predictor``; ``device`` overrides the
    config's."""
    return AnalysisPredictor(config, device=device)
