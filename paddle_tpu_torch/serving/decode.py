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

**Prefix sharing** (``prefix_cache=True``, ``serving/prefix_store.py``):
every prefill runs page-sized chunks through the one chunked-prefill
program (``build_chunk_prefill_program``); admission looks up the longest
cached chain of the prompt's full pages, splices those shared pages into
the page table and replays only the uncached chunks, bit for bit the
cold run's. **Session journaling** (``journal_sink``,
``serving/session.py``): every ``decode_journal_stride`` accepted tokens
a journaled request's record goes to the sink, and ``submit`` with
``prior_tokens`` and ``rng_state`` resumes it. **Shipments**
(``submit_prefill``, ``serving/disagg.py``): a prefill whose KV pages
come back as the wire format's bytes. A ``decode``-role engine with
``prefill_urls`` fetches each prompt's shipment from the prefill tier
(``_admit_shipped``), checks its CRCs, installs its pages into the pool
and samples the first token from the shipped logits; a fetch that fails
or a shipment that is rejected falls back to a local prefill on the same
device (``disagg.fallback_prefills``), as the reference does.

Fault sites (core/faults.py), the reference's: ``decode.step`` fails the
in-flight step (its requests get a per-request error, their pages go
back), ``decode.kv_alloc`` one request's page allocation,
``kv.prefix_lookup`` one request's prefix lookup and ``disagg.ship`` one
shipment. ``FLAGS_decode_step_delay_ms`` sleeps before each step (a
pacing knob: it keeps generations in flight long enough to kill a
replica mid-generation).

Entry points run on the card: ``device=None`` means ``cuda:0`` and raises
when CUDA is absent; tests pass ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..core import faults, incidents, telemetry
from ..core import flags as _flags
from ..core.executor import run_block
from ..core.graph import StepGraph
from ..core.flags import flag as _flag
from ..models.decoder_lm import (DecoderLMConfig,
                                 build_chunk_prefill_program,
                                 build_prefill_program, build_step_program,
                                 load_decoder_lm, params_from_numpy,
                                 quantize_decoder_lm_params)
from .admission import (AdmissionQueue, DeadlineExceededError,
                        EngineClosedError, InferenceRequest,
                        KVCacheExhaustedError, ServingError)
from .health import DRAINING, READY, STOPPED, HealthState
from .kv_cache import KVPagePool
from .prefix_store import PrefixStore, prefix_chain_hash
from .session import pack_rng_state, unpack_rng_state


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
        # prefix sharing (serving/prefix_store.py) and the disaggregated
        # role (serving/disagg.py)
        self.prefix_cache = bool(_flag("decode_prefix_cache")
                                 if prefix_cache is None else prefix_cache)
        self.role = str(_flag("decode_role") if role is None
                        else role).lower()
        if self.role not in ("unified", "prefill", "decode"):
            raise ValueError(f"decode role must be 'unified', 'prefill' "
                             f"or 'decode', got {self.role!r}")
        if prefill_urls is None:
            prefill_urls = _flag("disagg_prefill_urls")
        if isinstance(prefill_urls, str):
            prefill_urls = [u.strip() for u in prefill_urls.split(",")
                            if u.strip()]
        self.prefill_urls = [str(u) for u in prefill_urls]

    def bucket(self, active: int) -> int:
        for b in self.buckets:
            if active <= b:
                return b
        return self.buckets[-1]


class GenerationRequest(InferenceRequest):
    """One queued/running generation: prompt + sampling params + the
    engine-side decode state. ``result()`` returns the generated token
    ids as an int32 array. ``ttft_ms`` / ``token_walls`` give the time to
    the first token and each token's arrival; ``prefill_ms`` the wall
    time of its prefill."""

    __slots__ = ("prompt", "max_new_tokens", "temperature", "seed",
                 "eos_id", "stop_at_eos", "tokens", "token_walls",
                 "t_submit", "t_first", "prefill_ms", "pages", "table_row",
                 "pos_next", "last_token", "shared_blocks", "session_id",
                 "prior", "seq", "_rng")

    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 deadline: Optional[float], temperature: float = 0.0,
                 seed: Optional[int] = None, eos_id: Optional[int] = None,
                 session_id: Optional[str] = None,
                 prior: Optional[np.ndarray] = None):
        super().__init__({"prompt": prompt}, 1, deadline)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = seed
        self.eos_id = eos_id
        self.stop_at_eos = eos_id is not None
        self.tokens: List[int] = []
        self.token_walls: List[float] = []
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.prefill_ms: Optional[float] = None
        # session resumption (serving/session.py): ``prior`` holds the
        # tokens accepted in an earlier life of the request; the engine
        # prefills ``seq`` (prompt + prior) and generates the remainder
        self.session_id = session_id
        self.prior = (np.zeros(0, np.int32) if prior is None
                      else np.asarray(prior, np.int32).reshape(-1))
        self.seq = (prompt if self.prior.size == 0
                    else np.concatenate([prompt, self.prior]))
        self.pages: List[int] = []
        self.table_row: Optional[np.ndarray] = None
        self.pos_next = 0
        self.last_token = 0
        # prefix-store blocks this request holds a reference on, released
        # at retirement
        self.shared_blocks: List[str] = []
        self._rng = np.random.RandomState(seed) if seed is not None \
            else None

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3

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

    def journal_record(self, page_size: int,
                       now: Optional[float] = None) -> Dict[str, Any]:
        """Everything a resumption needs to continue this generation bit
        for bit (serving/session.py): the prompt and its page-chain hash,
        EVERY accepted token (earlier lives included), the sampler's RNG
        state after those draws, and the deadline's remainder. Worker
        thread only (reads the RNG)."""
        rem = None
        if self.deadline is not None:
            rem = max(0.0, (self.deadline
                            - (time.monotonic() if now is None else now))
                      * 1e3)
        return {
            "request_id": self.session_id,
            "prompt": [int(t) for t in self.prompt],
            "prefix_hash": prefix_chain_hash(self.prompt, page_size),
            "accepted": [int(t) for t in self.prior] + list(self.tokens),
            "max_new_total": int(self.prior.size) + self.max_new_tokens,
            "temperature": self.temperature,
            "seed": self.seed,
            "stop_at_eos": self.stop_at_eos,
            "rng_state": pack_rng_state(self._rng)
            if self.temperature > 0 else None,
            "deadline_remaining_ms": rem,
        }


class ShipPrefillRequest(InferenceRequest):
    """A prefill-and-ship work item (serving/disagg.py): the engine runs
    the prompt's prefill, reads the finished KV pages back to the host
    and resolves with the shipment's bytes. It rides the same queue as
    generations, so every program run stays on the worker thread."""

    __slots__ = ("prompt",)

    def __init__(self, prompt: np.ndarray, deadline: Optional[float]):
        super().__init__({"prompt": prompt}, 1, deadline)
        self.prompt = prompt


class DecodeEngine:
    """Thread-safe generative front end over a frozen decoder-LM param
    set: ``start()`` -> concurrent ``submit``/``generate`` ->
    ``close(drain=True)``. One worker thread owns the slot array, the
    pools and every program run.

    ``params`` is the JAX package's numpy parameter dict (fp32, or its
    int8 form), exactly what ``paddle_tpu``'s engine takes. ``version`` is
    the model version ``stats()`` and the HTTP surface report. ``device``
    defaults to cuda:0."""

    def __init__(self, model_cfg: DecoderLMConfig, params: Dict[str, Any],
                 config: Optional[DecodeConfig] = None, device=None,
                 version: int = 0):
        self.device = resolve_device(device)
        self.version = int(version)
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
                                    self.config.default_deadline_ms,
                                    metric_prefix="decode")
        if self.config.prefill_buckets is None:
            self.config.prefill_buckets = _pow2_ladder(
                min(8, model_cfg.max_seq_len), model_cfg.max_seq_len)
        self._active: List[GenerationRequest] = []
        self._blocks: Dict[Any, Any] = {}   # (phase, bucket) -> Block
        # (phase, bucket) -> (its static feed buffers, its StepGraph)
        self._graphs: Dict[Any, Any] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        # content-addressed prefix sharing: admission looks up the longest
        # cached prefix and prefills only the suffix, chunk by chunk
        self.prefix_store = PrefixStore(self.pool) \
            if self.config.prefix_cache else None
        self._thread: Optional[threading.Thread] = None
        self.health = HealthState()
        self._journal_sink = None
        self._journal_stride = int(_flag("decode_journal_stride"))

    @property
    def journal_sink(self):
        """Session journaling (serving/session.py): a callable taking a
        list of journal records, or None (the default: no journaling)."""
        return self._journal_sink

    @journal_sink.setter
    def journal_sink(self, sink):
        self._journal_sink = sink

    # -- client surface ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, seed: Optional[int] = None,
               stop_at_eos: bool = True,
               request_id: Optional[str] = None,
               prior_tokens: Optional[Sequence[int]] = None,
               rng_state: Optional[Any] = None) -> GenerationRequest:
        """Enqueue one generation (non-blocking). ``prompt`` is a 1-D int
        token-id array. Raises ValueError (malformed / over the model
        length), KVCacheExhaustedError (can never fit the KV pool),
        ServerOverloadedError, EngineClosedError.

        ``request_id`` opts the request into session journaling.
        ``prior_tokens`` and ``rng_state`` resume a journaled session
        (``session.resume_args``): the engine prefills prompt + prior,
        restores the sampler's RNG and generates only the remaining
        ``max_new_tokens``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt needs at least one token")
        prior = (np.zeros(0, np.int32) if prior_tokens is None
                 else np.asarray(prior_tokens, np.int32).reshape(-1))
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_tokens
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = int(prompt.size) + int(prior.size) + max_new_tokens
        if total > self.model_cfg.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size + prior.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's max_seq_len "
                f"({self.model_cfg.max_seq_len})")
        self.pool.check_fits(total)
        req = GenerationRequest(
            prompt, max_new_tokens, self.queue.deadline_for(deadline_ms),
            temperature=temperature, seed=seed,
            eos_id=self.model_cfg.eos_id if stop_at_eos else None,
            session_id=request_id, prior=prior)
        if rng_state is not None:
            req._rng = unpack_rng_state(rng_state)
        if prior.size:
            telemetry.counter_add("session.resumed", 1)
            telemetry.counter_add("session.resumed_tokens", int(prior.size))
        self.queue.submit_request(req)
        return req

    def generate(self, prompt, timeout: Optional[float] = None,
                 **kw) -> np.ndarray:
        """Blocking submit-and-wait; returns the generated int32 ids."""
        return self.submit(prompt, **kw).result(timeout)

    def submit_prefill(self, prompt, deadline_ms: Optional[float] = None
                       ) -> ShipPrefillRequest:
        """Enqueue a prefill-and-ship work item (serving/disagg.py):
        ``result()`` returns the prompt's KV page shipment as bytes. The
        pages go back to the pool once they are read."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt needs at least one token")
        if int(prompt.size) > self.model_cfg.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) exceeds the model's max_seq_len "
                f"({self.model_cfg.max_seq_len})")
        self.pool.check_fits(int(prompt.size))
        req = ShipPrefillRequest(prompt,
                                 self.queue.deadline_for(deadline_ms))
        self.queue.submit_request(req)
        return req

    def stats(self) -> Dict[str, Any]:
        """decode.* counters, KV pool accounting, kernel launch counts,
        latency percentiles and the rolling-window token rate."""
        snap = telemetry.snapshot()
        out = {k.split(".", 1)[1]: v for k, v in snap["counters"].items()
               if k.startswith("decode.")}
        out["queue_depth"] = self.queue.depth()
        out["model_version"] = self.version
        out["status"] = self.health.state
        out["role"] = self.config.role
        out["device"] = str(self.device)
        out["kv_cache"] = self.pool.stats()
        if self.prefix_store is not None:
            out["prefix_store"] = self.prefix_store.stats()
            out["prefix_store"].update(
                {k.split(".", 1)[1]: v for k, v in snap["counters"].items()
                 if k.startswith("kv.")})
        disagg = {k.split(".", 1)[1]: v for k, v in snap["counters"].items()
                  if k.startswith("disagg.")}
        if disagg:
            out["disagg"] = disagg
        # launches of each hand-written kernel (0 on the CPU, where the
        # wrappers run their plain versions)
        out["kernels"] = kernels.launch_counts()
        out["kernel_layouts"] = kernels.layout_counts()
        out["int8_instances"] = kernels.int8_instance_counts()
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
        if self.prefix_store is not None:
            # the one chunked-prefill program (chunk length = page size)
            P = self.config.page_size
            self._run("chunk", P, self._zero_feed("chunk", P))
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
            elif phase == "chunk":   # one request's chunk per run
                program, _, _ = build_chunk_prefill_program(
                    cfg, 1, bucket, cc.kv_pages, cc.page_size,
                    cc.weight_quant)
            else:   # one request per prefill run
                program, _, _ = build_prefill_program(
                    cfg, 1, bucket, cc.kv_pages, cc.page_size,
                    cc.weight_quant)
            blk = self._blocks[key] = program.global_block()
            telemetry.counter_add("decode.program_builds", 1)
        return blk

    def _run(self, phase: str, bucket: int, feed: Dict[str, Any],
             fetch: bool = True) -> Optional[np.ndarray]:
        """Run one (phase, bucket) program on the engine's params, pools
        and ``feed`` (host arrays, or tensors already on the engine's
        device, which are copied without a host sync); the pools update
        in place. Returns host logits, or None when not ``fetch``: the
        logits then stay on the device and nothing waits for the run.
        The first run of a (phase, bucket) goes op by op and captures the
        program (``_capture``); later runs copy ``feed`` into the
        captured step's buffers and replay it."""
        key = (phase, bucket)
        captured = self._graphs.get(key)
        if captured is None:
            captured, logits = self._capture(phase, bucket, feed)
            self._graphs[key] = captured
            return logits if fetch else None
        bufs, graph = captured
        for n, v in feed.items():
            bufs[n].copy_(torch.as_tensor(v))
        logits = graph.replay()[0]
        return logits.cpu().numpy() if fetch else None

    def _capture(self, phase: str, bucket: int, feed: Dict[str, Any]):
        """((static feed buffers, the program's StepGraph over them),
        the host logits of ``feed``): the step runs once op by op on
        buffers holding ``feed``, which is the first run's result, and is
        then captured in the engine's shared graph pool. The pool ops
        must write the engine's pools in place: they are the static
        tensors every captured program reads."""
        block = self._block(phase, bucket)
        bufs = {n: torch.as_tensor(v).to(self.device, copy=True)
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
        feed = {"tokens": np.zeros((1, bucket), np.int32),
                "lengths": np.ones(1, np.int32), "last_onehot": oh,
                "page_table": np.zeros((1, self._mp), np.int32)}
        if phase == "chunk":
            feed.update(positions=np.zeros((1, bucket), np.int32),
                        chunk_start=np.zeros(1, np.int32))
        return feed

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
                    self._journal_tick()
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
            # the SLO watchdog evaluates its rules on the step cadence
            incidents.tick()

    def _admit(self):
        """Seat queued requests into free slots at the step boundary. With
        the prefix store on: look up the longest cached prefix, allocate
        the rest, reclaim idle chains once if the pool is short, and
        release the looked-up blocks on every failure."""
        free = self.config.max_slots - len(self._active)
        if free <= 0:
            return
        unseated: List[GenerationRequest] = []
        polled = self.queue.poll(free)
        for i, req in enumerate(polled):
            if isinstance(req, ShipPrefillRequest):
                self._ship_prefill(req)
                continue
            # disaggregated decode role: install a shipped prefill from
            # the prefill tier; any failure falls back to a local prefill
            if (self.config.role == "decode" and self.config.prefill_urls
                    and self._admit_shipped(req)):
                continue
            hashes: List[str] = []
            shared: List[int] = []
            if self.prefix_store is not None:
                try:
                    hashes, shared = self.prefix_store.lookup(req.seq)
                except Exception as e:   # injected kv.prefix_lookup fault
                    telemetry.counter_add("decode.errors", 1)
                    req.fail(e if isinstance(e, ServingError) else
                             ServingError(f"prefix lookup failed: {e!r}"))
                    continue
            need = self.pool.pages_for_tokens(
                int(req.seq.size) + req.max_new_tokens) - len(hashes)
            try:
                pages = self.pool.try_alloc(need)
                if not pages and self.prefix_store is not None:
                    # pool pressure: evict idle chains LRU-first, retry once
                    short = need - self.pool.free_pages()
                    if short > 0 and self.prefix_store.reclaim(short):
                        pages = self.pool.try_alloc(need)
            except Exception as e:   # injected decode.kv_alloc fault
                if hashes:
                    self.prefix_store.release(hashes)
                telemetry.counter_add("decode.errors", 1)
                req.fail(e if isinstance(e, ServingError) else ServingError(
                    f"KV page allocation failed: {e!r}"))
                continue
            if not pages:
                if hashes:
                    self.prefix_store.release(hashes)
                unseated.append(req)   # no headroom now — wait for frees
                continue
            try:
                if self.prefix_store is not None:
                    self._prefill_chunked(req, pages, hashes, shared)
                else:
                    self._prefill(req, pages)
            except BaseException as e:
                self.pool.free(req.pages if req.pages else pages)
                req.pages = []
                held = req.shared_blocks or hashes
                if held:
                    self.prefix_store.release(held)
                req.shared_blocks = []
                telemetry.counter_add("decode.errors", 1)
                req.fail(e if isinstance(e, ServingError) else ServingError(
                    f"prefill failed: {e!r}"))
                if not isinstance(e, Exception):
                    self.queue.requeue(unseated + polled[i + 1:])
                    raise
        self.queue.requeue(unseated)

    def _seat(self, req: GenerationRequest, logits_row: np.ndarray,
              t0: float):
        """After a prefill: the first token from its logits, then the
        request rides the decode step (or retires at once).
        ``req.prefill_ms`` is the prefill's wall time from ``t0``."""
        req.prefill_ms = (time.perf_counter() - t0) * 1e3
        telemetry.counter_add("decode.prefills", 1)
        self._append_token(req, logits_row)
        req.pos_next = int(req.seq.size)
        if req.finished():
            self._retire(req)
        else:
            self._active.append(req)

    def _prefill(self, req: GenerationRequest, pages: List[int]):
        """PREFILL: one causal pass over the padded prompt (+ prior)."""
        t0 = time.perf_counter()
        L = int(req.seq.size)
        bucket = next(b for b in self.config.prefill_buckets if b >= L)
        req.pages = pages
        row = np.zeros(self._mp, np.int32)
        row[:len(pages)] = pages
        req.table_row = row
        feed = self._prefill_feed(req.seq, bucket, row)
        with telemetry.timer("decode.prefill_ms"):
            logits = self._run("prefill", bucket, feed)
        telemetry.counter_add("decode.prefill_tokens", L)
        self._seat(req, logits[0], t0)

    def _prefill_feed(self, seq: np.ndarray, bucket: int, row: np.ndarray
                      ) -> Dict[str, np.ndarray]:
        L = int(seq.size)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :L] = seq
        oh = np.zeros((1, bucket), np.float32)
        oh[0, L - 1] = 1.0
        return {"tokens": tokens, "lengths": np.asarray([L], np.int32),
                "last_onehot": oh, "page_table": row[None, :].copy()}

    def _prefill_chunked(self, req: GenerationRequest, pages: List[int],
                         hashes: List[str], shared: List[int]):
        """Chunked prefill (prefix store on): the page table splices the
        ``len(hashes)`` shared prefix pages in front of the private ones,
        then each UNCACHED page-sized chunk runs through the one
        fixed-shape chunk program. Writes land only in private pages (the
        lookup's match cap keeps the final chunk, which yields the
        first-token logits, always recomputed); afterwards the store
        adopts this prompt's full pages, so the next request shares
        them."""
        t0 = time.perf_counter()
        L = int(req.seq.size)
        P = self.config.page_size
        k = len(hashes)
        req.pages = pages
        req.shared_blocks = list(hashes)
        row = np.zeros(self._mp, np.int32)
        row[:k] = shared
        row[k:k + len(pages)] = pages
        req.table_row = row
        n_chunks = -(-L // P)
        feeds = self._chunk_feeds(req.seq, row, k)
        with telemetry.timer("decode.prefill_ms"):
            logits = self._run_chunks(feeds)
        telemetry.counter_add("decode.prefill_tokens", L - k * P)
        telemetry.counter_add("decode.prefill_chunks", n_chunks - k)
        # the store adopts every FULL prompt page (strictly before the
        # page receiving decode writes): repoint the table at the
        # canonical pages and keep only the tail pages private
        n_full = L // P
        if n_full > k:
            held, canon = self.prefix_store.insert(
                req.seq, [int(p) for p in row[:n_full]], start_block=k)
            row[k:n_full] = canon
            req.shared_blocks.extend(held)
            req.pages = pages[n_full - k:]
        self._seat(req, logits[0], t0)

    def _chunk_feeds(self, seq: np.ndarray, row: np.ndarray, first: int
                     ) -> Dict[str, np.ndarray]:
        """The chunk program's feeds for the page-sized chunks ``first``..
        of ``seq``, stacked on a leading chunk axis; the last chunk's
        one-hot marks the prompt's last token."""
        L = int(seq.size)
        P = self.config.page_size
        n_chunks = -(-L // P)
        lo = (first + np.arange(n_chunks - first, dtype=np.int32)) * P
        padded = np.zeros(n_chunks * P, np.int32)
        padded[:L] = seq
        oh = np.zeros((lo.size, 1, P), np.float32)
        oh[-1, 0, L - 1 - lo[-1]] = 1.0
        return {"tokens": padded[first * P:].reshape(-1, 1, P),
                "positions": np.clip(
                    lo[:, None, None] + np.arange(P, dtype=np.int32), 0,
                    self.model_cfg.max_seq_len - 1),
                "chunk_start": lo[:, None],
                "lengths": np.minimum(L - lo, P)[:, None],
                "last_onehot": oh,
                "page_table": np.repeat(row[None, None, :], lo.size, 0)}

    def _run_chunks(self, feeds: Dict[str, np.ndarray]) -> np.ndarray:
        """Run the chunk program once per chunk of ``feeds``
        (``_chunk_feeds``), in order; returns the last chunk's host
        logits. The feeds go to the device in one copy each; each run
        takes its slice there, so nothing waits for the device before
        the last chunk's logits are read."""
        dev = {n: torch.from_numpy(v).to(self.device)
               for n, v in feeds.items()}
        last = len(feeds["tokens"]) - 1
        logits = None
        for ci in range(last + 1):
            logits = self._run("chunk", self.config.page_size,
                               {n: t[ci] for n, t in dev.items()},
                               fetch=ci == last)
        return logits

    def _ship_prefill(self, req: ShipPrefillRequest):
        """Prefill-and-ship (serving/disagg.py): run the prompt's classic
        prefill, read its finished pages back to the host, pack the
        shipment, free the pages and resolve with the bytes. A failure
        (``disagg.ship`` faults inject here) is the request's own; the pool
        stays clean."""
        from . import disagg

        pages: List[int] = []
        try:
            faults.maybe_fail("disagg.ship", tokens=int(req.prompt.size))
            L = int(req.prompt.size)
            n_pages = self.pool.pages_for_tokens(L)
            pages = self.pool.try_alloc(n_pages)
            if not pages:
                raise KVCacheExhaustedError(
                    f"cannot seat {n_pages} pages for a shipment right now")
            bucket = next(b for b in self.config.prefill_buckets if b >= L)
            row = np.zeros(self._mp, np.int32)
            row[:n_pages] = pages
            with telemetry.timer("decode.prefill_ms"):
                logits = self._run("prefill", bucket,
                                   self._prefill_feed(req.prompt, bucket,
                                                      row))
            idx = torch.as_tensor(pages, dtype=torch.int64,
                                  device=self.device)
            layer_pages = {name: self._pools[name][idx].cpu().numpy()
                           for name in sorted(self._pools)}
            blob = disagg.pack_shipment(req.prompt, self.config.page_size,
                                        layer_pages, logits[0])
            self.pool.free(pages)
            pages = []
            telemetry.counter_add("disagg.ships", 1)
            telemetry.counter_add("disagg.ship_bytes", len(blob))
            req.resolve(blob)
        except Exception as e:
            if pages:
                self.pool.free(pages)
            telemetry.counter_add("decode.errors", 1)
            req.fail(e if isinstance(e, ServingError) else ServingError(
                f"prefill shipment failed: {e!r}"))

    def _admit_shipped(self, req: GenerationRequest) -> bool:
        """Decode-tier admission (serving/disagg.py): fetch the prompt's
        KV page shipment from the prefill tier, check its CRCs, copy its
        pages into the pool in place and seat the request with its first
        token sampled from the shipped logits. Returns False on any
        failure (connection, HTTP error, CRC reject, a shipment for
        another prompt, no pool headroom), after which the caller runs
        the prefill locally (``disagg.fallback_prefills``): a corrupt
        shipment is prefilled again, never served."""
        import zlib

        from . import disagg

        urls = self.config.prefill_urls
        pages: List[int] = []
        try:
            url = urls[zlib.crc32(req.seq.tobytes()) % len(urls)]
            blob = disagg.fetch_prefill(url, req.seq)
            ship = disagg.unpack_shipment(blob)   # raises on a CRC reject
            L = int(req.seq.size)
            if (ship["page_size"] != self.config.page_size
                    or ship["tokens"] != [int(t) for t in req.seq]
                    or set(ship["layers"]) != set(self._pools)):
                raise disagg.ShipmentError(
                    "shipment does not match the request")
            need = self.pool.pages_for_tokens(L + req.max_new_tokens)
            pages = self.pool.try_alloc(need)
            if not pages:
                return False
            idx = torch.as_tensor(pages[:ship["n_pages"]], dtype=torch.int64,
                                  device=self.device)
            for name, arr in ship["layers"].items():
                pool = self._pools[name]
                pool[idx] = torch.from_numpy(arr.copy()).to(self.device,
                                                            pool.dtype)
            req.pages = pages
            pages = []
            row = np.zeros(self._mp, np.int32)
            row[:len(req.pages)] = req.pages
            req.table_row = row
            telemetry.counter_add("disagg.installs", 1)
            telemetry.counter_add("decode.prefills", 1)
            self._append_token(req, np.asarray(ship["logits"]))
            req.pos_next = L
            if req.finished():
                self._retire(req)
            else:
                self._active.append(req)
            return True
        except Exception:
            if pages:
                self.pool.free(pages)
            telemetry.counter_add("disagg.fallback_prefills", 1)
            return False

    def _run_step(self):
        """DECODE: one fixed-shape step over the padded slot array;
        per-request deadlines are checked here, at step granularity."""
        delay_ms = float(_flag("decode_step_delay_ms"))
        if delay_ms > 0:   # pacing knob, off by default
            time.sleep(delay_ms / 1e3)
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
        faults.maybe_fail("decode.step", active=len(active), bucket=bucket)
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

    def _journal_tick(self):
        """Hand the session records to the journal sink at the step
        boundary (serving/session.py), every ``decode_journal_stride``
        accepted tokens. Right after a step the record is a consistent
        cut: every accepted token is in it and the RNG has consumed
        exactly their draws. A failing sink costs replay depth, never the
        generation (``session.journal_errors``)."""
        sink = self._journal_sink
        stride = self._journal_stride
        if sink is None or stride <= 0:
            return
        now = time.monotonic()
        records = [req.journal_record(self.config.page_size, now)
                   for req in self._active
                   if req.session_id is not None and req.tokens
                   and (int(req.prior.size) + len(req.tokens)) % stride == 0]
        if not records:
            return
        try:
            sink(records)
        except Exception:
            telemetry.counter_add("session.journal_errors", 1)

    def _append_token(self, req: GenerationRequest, logits_row: np.ndarray):
        tok = req.sample(logits_row)
        now = time.monotonic()
        if req.t_first is None:
            req.t_first = now
        req.tokens.append(tok)
        req.token_walls.append(now)
        req.last_token = tok

    def _retire(self, req: GenerationRequest,
                error: Optional[BaseException] = None):
        """Free the request's private pages, drop its prefix-store
        references (the shared pages stay cached) and resolve or fail it —
        finished sequences leave without draining the batch."""
        if req.pages:
            self.pool.free(req.pages)
            req.pages = []
        if req.shared_blocks:
            self.prefix_store.release(req.shared_blocks)
            req.shared_blocks = []
        telemetry.counter_add("decode.retired", 1)
        telemetry.observe("decode.request_ms",
                          (time.monotonic() - req.t_submit) * 1e3)
        if error is not None:
            req.fail(error)
        else:
            req.resolve(np.asarray(req.tokens, np.int32))


def decode_engine_from_dir(model_dir: str,
                           config: Optional[DecodeConfig] = None,
                           device=None, version: int = 0) -> DecodeEngine:
    """Servable dir (``save_decoder_lm`` of either package) -> engine."""
    cfg, params = load_decoder_lm(model_dir)
    return DecodeEngine(cfg, params, config=config, device=device,
                        version=version)
