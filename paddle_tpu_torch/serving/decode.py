"""DecodeEngine — continuous-batching autoregressive generation over a
paged KV cache, on PyTorch (port of ``paddle_tpu/serving/decode.py``).

* **Phase split.** An admitted request runs ONE prefill program
  (``models/decoder_lm.build_prefill_program``, padded to a prompt-length
  bucket) that writes the prompt's K/V into its pool pages and yields the
  first token; from then on it rides the shared decode step.
* **Continuous batching.** Decode state lives in ``max_slots`` recycled
  slots. Every iteration retires finished or expired sequences (freeing
  their pages) and admits queued requests into the vacated slots. The
  step runs at fixed slot-array buckets (by default one bucket of
  ``max_slots``), so per-row math is independent of occupancy and
  continuous-batched generations are BITWISE-identical to sequential
  one-request-at-a-time decode.
* **Paged KV cache.** Pool tensors come from ``KVPagePool`` on the
  engine's device and are updated in place by the programs' pool ops.
* **int8 weight-only serving** (``weight_quant="int8"``): dense weights
  are stored int8 with per-output-channel scales and run through the
  int8 GEMM kernel.

Each (phase, bucket) program is built once, run op by op through
``core/executor.run_block`` on its first use (``warmup`` makes that
first use), then captured with static input buffers as a
``core/graph.StepGraph``: a CUDA graph on the card, replayed for every
later run of that (phase, bucket), as the reference jits each
(phase, bucket) program. All graphs of one engine share one memory pool:
they never run at once. On the CPU the same static-buffer step is called
directly. One worker thread owns every program run and all CUDA work.
Sampling is host-side per row (greedy argmax, or temperature sampling
from a per-request ``np.random.RandomState``), so token choice is a pure
function of the row's logits and the request's own seed.

Entry points run on the card: ``device=None`` means ``cuda:0`` and raises
when CUDA is absent; tests pass ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version. Not in this slice (they raise
``NotImplementedError``): the prefix cache, the disaggregated roles and
prefill tier, and session journaling.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..core import flags as _flags
from ..core import telemetry
from ..core.executor import run_block
from ..core.graph import StepGraph
from ..core.flags import flag as _flag
from ..models.decoder_lm import (DecoderLMConfig, build_prefill_program,
                                 build_step_program, load_decoder_lm,
                                 params_from_numpy,
                                 quantize_decoder_lm_params)
from .admission import (AdmissionQueue, DeadlineExceededError,
                        EngineClosedError, InferenceRequest, ServingError)
from .health import DRAINING, READY, STOPPED, HealthState
from .kv_cache import KVPagePool


def _pow2_ladder(lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return sorted(set(out))


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda:0. A CUDA device without CUDA raises: an entry
    point never carries on on the CPU unless the caller asks for it."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch serves on a CUDA device and torch.cuda is "
            "not available here; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


class DecodeConfig:
    """Decode-engine knobs; defaults come from the FLAGS_decode_*
    registry."""

    def __init__(self, max_slots: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 max_new_tokens: Optional[int] = None,
                 weight_quant: Optional[str] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 prefix_cache: Optional[bool] = None,
                 role: Optional[str] = None,
                 prefill_urls: Optional[Any] = None):
        self.max_slots = int(_flag("decode_max_slots") if max_slots is None
                             else max_slots)
        spec = _flag("decode_buckets") if buckets is None else buckets
        self.buckets = _flags.parse_buckets(
            spec, "buckets", cover=self.max_slots,
            cover_exact=True) or [self.max_slots]
        self.page_size = int(_flag("decode_page_size") if page_size is None
                             else page_size)
        self.kv_pages = int(_flag("decode_kv_pages") if kv_pages is None
                            else kv_pages)
        self.max_queue_depth = int(
            _flag("decode_max_queue_depth") if max_queue_depth is None
            else max_queue_depth)
        self.default_deadline_ms = float(
            _flag("decode_default_deadline_ms") if default_deadline_ms is None
            else default_deadline_ms)
        self.max_new_tokens = int(
            _flag("decode_max_new_tokens") if max_new_tokens is None
            else max_new_tokens)
        self.weight_quant = str(
            _flag("decode_weight_quant") if weight_quant is None
            else weight_quant).lower()
        if self.weight_quant not in ("none", "int8"):
            raise ValueError(f"decode weight_quant must be 'none' or "
                             f"'int8', got {self.weight_quant!r}")
        self.prefill_buckets = sorted(set(int(b) for b in prefill_buckets)) \
            if prefill_buckets else None   # None -> pow2 up to max_seq_len
        prefix_cache = bool(_flag("decode_prefix_cache")
                            if prefix_cache is None else prefix_cache)
        role = str(_flag("decode_role") if role is None else role).lower()
        if prefill_urls is None:
            prefill_urls = _flag("disagg_prefill_urls")
        if isinstance(prefill_urls, str):
            prefill_urls = [u for u in prefill_urls.split(",") if u.strip()]
        if prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True (the chunked-prefill prefix store) is "
                "not in this slice of the port")
        if role != "unified":
            raise NotImplementedError(
                f"decode role {role!r}: only 'unified' is in this slice of "
                f"the port")
        if prefill_urls:
            raise NotImplementedError(
                "prefill_urls (the disaggregated prefill tier) is not in "
                "this slice of the port")
        self.prefix_cache = False
        self.role = role

    def bucket(self, active: int) -> int:
        for b in self.buckets:
            if active <= b:
                return b
        return self.buckets[-1]


class GenerationRequest(InferenceRequest):
    """One queued/running generation: prompt + sampling params + the
    engine-side decode state. ``result()`` returns the generated token
    ids as an int32 array."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "eos_id",
                 "tokens", "t_submit", "pages", "table_row", "pos_next",
                 "last_token", "_rng")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 deadline: Optional[float], temperature: float = 0.0,
                 seed: Optional[int] = None, eos_id: Optional[int] = None):
        super().__init__(deadline)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.tokens: List[int] = []
        self.t_submit = time.monotonic()
        self.pages: List[int] = []
        self.table_row: Optional[np.ndarray] = None
        self.pos_next = 0
        self.last_token = 0
        self._rng = np.random.RandomState(seed) if seed is not None \
            else None

    def sample(self, logits_row: np.ndarray) -> int:
        """Greedy when temperature <= 0 (argmax, lowest index on ties);
        else softmax-at-temperature inverse-CDF driven by the pinned
        per-request RandomState — the reference's sampler, unchanged."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits_row))
        if self._rng is None:
            raise ValueError("sampled decoding (temperature > 0) needs a "
                             "per-request seed for reproducible serving")
        z = logits_row.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        idx = np.searchsorted(np.cumsum(p), self._rng.random_sample())
        return int(min(idx, len(p) - 1))

    def finished(self) -> bool:
        return bool(self.tokens) and (
            len(self.tokens) >= self.max_new_tokens
            or (self.eos_id is not None and self.tokens[-1] == self.eos_id))


class DecodeEngine:
    """Thread-safe generative front end over a frozen decoder-LM param
    set: ``start()`` -> concurrent ``submit``/``generate`` ->
    ``close(drain=True)``. One worker thread owns the slot array, the
    pools and every program run.

    ``params`` is the JAX package's numpy parameter dict (fp32, or its
    int8 form), exactly what ``paddle_tpu``'s engine takes. ``device``
    defaults to cuda:0."""

    def __init__(self, model_cfg: DecoderLMConfig, params: Dict[str, Any],
                 config: Optional[DecodeConfig] = None, device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.config = config or DecodeConfig()
        params = {n: v.detach().cpu().numpy() if torch.is_tensor(v)
                  else np.asarray(v) for n, v in params.items()}
        if self.config.weight_quant == "int8":
            params = quantize_decoder_lm_params(params, model_cfg)
            telemetry.counter_add("decode.int8_weight_tensors",
                                  sum(1 for n in params
                                      if n.endswith("_w_i8")))
        self._params = params_from_numpy(params, self.device)
        self.pool = KVPagePool(model_cfg.n_layers, self.config.kv_pages,
                               self.config.page_size, model_cfg.d_model)
        self._pools = self.pool.make_arrays(self.device)
        self._mp = -(-model_cfg.max_seq_len // self.config.page_size)
        self.queue = AdmissionQueue(self.config.max_queue_depth,
                                    self.config.default_deadline_ms)
        if self.config.prefill_buckets is None:
            self.config.prefill_buckets = _pow2_ladder(
                min(8, model_cfg.max_seq_len), model_cfg.max_seq_len)
        self._active: List[GenerationRequest] = []
        self._blocks: Dict[Any, Any] = {}   # (phase, bucket) -> Block
        # (phase, bucket) -> (its static feed buffers, its StepGraph)
        self._graphs: Dict[Any, Any] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        self._thread: Optional[threading.Thread] = None
        self.health = HealthState()

    @property
    def journal_sink(self):
        return None

    @journal_sink.setter
    def journal_sink(self, sink):
        if sink is not None:
            raise NotImplementedError(
                "session journaling (journal_sink) is not in this slice of "
                "the port")

    # -- client surface ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, seed: Optional[int] = None,
               stop_at_eos: bool = True) -> GenerationRequest:
        """Enqueue one generation (non-blocking). ``prompt`` is a 1-D int
        token-id array. Raises ValueError (malformed / over the model
        length), KVCacheExhaustedError (can never fit the KV pool),
        ServerOverloadedError, EngineClosedError."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt needs at least one token")
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_tokens
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = int(prompt.size) + max_new_tokens
        if total > self.model_cfg.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's max_seq_len "
                f"({self.model_cfg.max_seq_len})")
        self.pool.check_fits(total)
        req = GenerationRequest(
            prompt, max_new_tokens, self.queue.deadline_for(deadline_ms),
            temperature=temperature, seed=seed,
            eos_id=self.model_cfg.eos_id if stop_at_eos else None)
        self.queue.submit_request(req)
        return req

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Blocking submit-and-wait; returns the generated int32 ids."""
        return self.submit(prompt, **kw).result(timeout)

    def stats(self) -> Dict[str, Any]:
        """decode.* counters, KV pool accounting, kernel launch counts,
        latency percentiles and the rolling-window token rate."""
        snap = telemetry.snapshot()
        out = {k.split(".", 1)[1]: v for k, v in snap["counters"].items()
               if k.startswith("decode.")}
        out["queue_depth"] = self.queue.depth()
        out["status"] = self.health.state
        out["role"] = self.config.role
        out["device"] = str(self.device)
        out["kv_cache"] = self.pool.stats()
        # launches of each hand-written kernel (0 on the CPU, where the
        # wrappers run their plain versions)
        out["kernels"] = kernels.launch_counts()
        hists = snap["hists"]
        for key in ("decode.step_ms", "decode.prefill_ms",
                    "decode.request_ms"):
            h = hists.get(key)
            if h:
                out[key.split(".", 1)[1]] = {
                    k: h[k] for k in ("count", "avg", "p50", "p95", "p99",
                                      "max")}
        occ = hists.get("decode.batch_occupancy")
        if occ:
            out["batch_occupancy"] = {"avg": occ["avg"], "p50": occ["p50"]}
        win = telemetry.windowed()
        wout = {"seconds": win["window_s"]}
        for name, key in (("decode.tokens", "tokens_per_s"),
                          ("decode.steps", "steps_per_s")):
            if name in win["counters"]:
                wout[key] = win["counters"][name]["rate"]
        out["window"] = wout
        return out

    # -- lifecycle -----------------------------------------------------------
    def start(self, warmup: bool = False) -> "DecodeEngine":
        if self._thread is not None:
            return self
        if self.queue.closed:
            raise EngineClosedError("decode engine was closed; "
                                    "build a new one")
        if warmup:
            self.warmup()
        self._thread = threading.Thread(target=self._loop,
                                        name="pt-torch-decode-engine",
                                        daemon=True)
        self._thread.start()
        self.health.set(READY)
        return self

    def warmup(self) -> int:
        """Build every step and prefill program, run each once on zero
        feeds (writes land in scratch page 0 only) and capture it, so no
        request pays a program build, a kernel build or a capture
        mid-load. Call before ``start()``. Returns the number of programs
        built."""
        before = len(self._blocks)
        for b in self.config.buckets:
            self._run("step", b, self._zero_feed("step", b))
        for b in self.config.prefill_buckets:
            self._run("prefill", b, self._zero_feed("prefill", b))
        return len(self._blocks) - before

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        self.health.set(DRAINING)
        self.queue.close(drain=drain)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.health.set(STOPPED)

    # -- programs ------------------------------------------------------------
    def _block(self, phase: str, bucket: int):
        key = (phase, bucket)
        blk = self._blocks.get(key)
        if blk is None:
            cfg, cc = self.model_cfg, self.config
            if phase == "step":
                program, _, _ = build_step_program(
                    cfg, bucket, cc.kv_pages, cc.page_size, cc.weight_quant)
            else:   # one request per prefill run
                program, _, _ = build_prefill_program(
                    cfg, 1, bucket, cc.kv_pages, cc.page_size,
                    cc.weight_quant)
            blk = self._blocks[key] = program.global_block()
            telemetry.counter_add("decode.program_builds", 1)
        return blk

    def _run(self, phase: str, bucket: int, feed: Dict[str, np.ndarray]
             ) -> np.ndarray:
        """Run one (phase, bucket) program on the engine's params, pools
        and ``feed``; the pools update in place. Returns host logits. The
        first run of a (phase, bucket) goes op by op and captures the
        program (``_capture``); later runs copy ``feed`` into the
        captured step's buffers and replay it."""
        key = (phase, bucket)
        captured = self._graphs.get(key)
        if captured is None:
            captured, logits = self._capture(phase, bucket, feed)
            self._graphs[key] = captured
            return logits
        bufs, graph = captured
        for n, v in feed.items():
            bufs[n].copy_(torch.from_numpy(v))
        return graph.replay()[0].cpu().numpy()

    def _capture(self, phase: str, bucket: int,
                 feed: Dict[str, np.ndarray]):
        """((static feed buffers, the program's StepGraph over them),
        the host logits of ``feed``): the step runs once op by op on
        buffers holding ``feed``, which is the first run's result, and is
        then captured in the engine's shared graph pool. The pool ops
        must write the engine's pools in place: they are the static
        tensors every captured program reads."""
        block = self._block(phase, bucket)
        bufs = {n: torch.from_numpy(v).to(self.device)
                for n, v in feed.items()}

        def step():
            env = dict(self._params)
            env.update(self._pools)
            env.update(bufs)
            run_block(block, env)
            for n, pool in self._pools.items():
                if env[n + "_out"] is not pool:
                    raise RuntimeError(f"decode: {n} was not written in "
                                       f"place")
            return [env["logits"]]

        logits = step()[0].cpu().numpy()
        graph = StepGraph(step, self.device, pool=self._graph_pool)
        graph.capture()
        telemetry.counter_add("decode.graph_captures", 1)
        return (bufs, graph), logits

    def _zero_feed(self, phase: str, bucket: int) -> Dict[str, np.ndarray]:
        if phase == "step":
            return {"tokens": np.zeros(bucket, np.int32),
                    "positions": np.zeros(bucket, np.int32),
                    "page_table": np.zeros((bucket, self._mp), np.int32)}
        oh = np.zeros((1, bucket), np.float32)
        oh[0, 0] = 1.0
        return {"tokens": np.zeros((1, bucket), np.int32),
                "lengths": np.ones(1, np.int32), "last_onehot": oh,
                "page_table": np.zeros((1, self._mp), np.int32)}

    # -- scheduler loop ------------------------------------------------------
    def _loop(self):
        while True:
            if not self._active:
                if not self.queue.wait_for_work(0.05):
                    if self.queue.closed:
                        return
                    continue
            try:
                self._admit()
                if self._active:
                    self._run_step()
            except BaseException as e:
                # the loop outlives any failed step: its requests fail,
                # their pages go back; interrupts and exits still end it
                telemetry.counter_add("decode.errors",
                                      max(1, len(self._active)))
                err = e if isinstance(e, ServingError) else ServingError(
                    f"decode step failed: {e!r}")
                for req in self._active:
                    self._retire(req, error=err)
                self._active = []
                if not isinstance(e, Exception):
                    raise
            telemetry.gauge_set("decode.active_slots", len(self._active))

    def _admit(self):
        """Seat queued requests into free slots at the step boundary."""
        free = self.config.max_slots - len(self._active)
        if free <= 0:
            return
        unseated: List[GenerationRequest] = []
        polled = self.queue.poll(free)
        for i, req in enumerate(polled):
            need = self.pool.pages_for_tokens(
                int(req.prompt.size) + req.max_new_tokens)
            pages = self.pool.try_alloc(need)
            if not pages:
                unseated.append(req)   # no headroom now — wait for frees
                continue
            try:
                self._prefill(req, pages)
            except BaseException as e:
                self.pool.free(req.pages or pages)
                req.pages = []
                telemetry.counter_add("decode.errors", 1)
                req.fail(e if isinstance(e, ServingError) else ServingError(
                    f"prefill failed: {e!r}"))
                if not isinstance(e, Exception):
                    self.queue.requeue(unseated + polled[i + 1:])
                    raise
        self.queue.requeue(unseated)

    def _prefill(self, req: GenerationRequest, pages: List[int]):
        """PREFILL: one causal pass over the padded prompt."""
        L = int(req.prompt.size)
        bucket = next(b for b in self.config.prefill_buckets if b >= L)
        req.pages = pages
        row = np.zeros(self._mp, np.int32)
        row[:len(pages)] = pages
        req.table_row = row
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :L] = req.prompt
        oh = np.zeros((1, bucket), np.float32)
        oh[0, L - 1] = 1.0
        feed = {"tokens": tokens, "lengths": np.asarray([L], np.int32),
                "last_onehot": oh, "page_table": row[None, :].copy()}
        with telemetry.timer("decode.prefill_ms"):
            logits = self._run("prefill", bucket, feed)
        telemetry.counter_add("decode.prefills", 1)
        telemetry.counter_add("decode.prefill_tokens", L)
        self._append_token(req, logits[0])
        req.pos_next = L
        if req.finished():
            self._retire(req)
        else:
            self._active.append(req)

    def _run_step(self):
        """DECODE: one fixed-shape step over the padded slot array;
        per-request deadlines are checked here, at step granularity."""
        now = time.monotonic()
        for req in [r for r in self._active if r.expired(now)]:
            self._active.remove(req)
            telemetry.counter_add("decode.deadline_expired", 1)
            self._retire(req, error=DeadlineExceededError(
                f"generation deadline elapsed after {len(req.tokens)} of "
                f"{req.max_new_tokens} tokens"))
        if not self._active:
            return
        active = self._active
        bucket = self.config.bucket(len(active))
        tokens = np.zeros(bucket, np.int32)
        positions = np.zeros(bucket, np.int32)
        table = np.zeros((bucket, self._mp), np.int32)
        for i, req in enumerate(active):
            tokens[i] = req.last_token
            positions[i] = req.pos_next
            table[i] = req.table_row
        feed = {"tokens": tokens, "positions": positions,
                "page_table": table}
        with telemetry.timer("decode.step_ms"):
            logits = self._run("step", bucket, feed)
        telemetry.counter_add("decode.steps", 1)
        telemetry.counter_add("decode.tokens", len(active))
        telemetry.observe("decode.batch_occupancy", len(active) / bucket)
        still = []
        for i, req in enumerate(active):
            self._append_token(req, logits[i])
            req.pos_next += 1
            if req.finished():
                self._retire(req)
            else:
                still.append(req)
        self._active = still

    def _append_token(self, req: GenerationRequest, logits_row: np.ndarray):
        tok = req.sample(logits_row)
        req.tokens.append(tok)
        req.last_token = tok

    def _retire(self, req: GenerationRequest,
                error: Optional[BaseException] = None):
        """Free the request's pages and resolve or fail it — finished
        sequences leave without draining the batch."""
        if req.pages:
            self.pool.free(req.pages)
            req.pages = []
        telemetry.counter_add("decode.retired", 1)
        telemetry.observe("decode.request_ms",
                          (time.monotonic() - req.t_submit) * 1e3)
        if error is not None:
            req.fail(error)
        else:
            req.resolve(np.asarray(req.tokens, np.int32))


def decode_engine_from_dir(model_dir: str,
                           config: Optional[DecodeConfig] = None,
                           device=None) -> DecodeEngine:
    """Servable dir (written by ``paddle_tpu``'s save_decoder_lm) ->
    engine."""
    cfg, params = load_decoder_lm(model_dir)
    return DecodeEngine(cfg, params, config=config, device=device)
