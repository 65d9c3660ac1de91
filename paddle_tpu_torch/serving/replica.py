"""Replica runner: one serving process of a cluster (port of
``paddle_tpu/serving/replica.py``).

    python -m paddle_tpu_torch.serving.replica --model-root ROOT \
        [--max-batch-size N] [--batch-timeout-ms MS] [--no-warmup] \
        [--poll-s S] [--device cuda|cpu] [--host H] [--port P]
    python -m paddle_tpu_torch.serving.replica --model-dir DIR ...
    python -m paddle_tpu_torch.serving.replica --decode-model-dir DIR \
        [--role unified|prefill|decode] [--prefill-urls URL[,URL]] \
        [--prefix-cache] [--journal-url URL] [--device cuda|cpu] ...
    ... [--telemetry-log PATH]

The predictor replica (``run_replica``) serves the newest verified
version under a published-models root (``checkpoint.publish_model``
layout), or a bare inference-model dir as version 0, through a
micro-batching ServingEngine over ``/v1/infer``, and swaps its model on
``POST /v1/admin/swap`` (the cluster controller's rolling swap) or, with
``--poll-s`` > 0, on its own when a newer version is published. The
decode replica (``run_decode_replica``) builds a DecodeEngine over a
decoder-LM servable dir (``/v1/generate``). Both run on ``--device``
(default cuda, which raises without CUDA), bind the HTTP server first so
a controller can watch ``/healthz`` go from ``starting`` to ``ok`` while
the engine warms up, and serve until told to stop. On the card the
engine loads the kernel libraries that ``kernels/_build.py`` built into
``build/torch_kernels/``, building any that is missing.

The process announces itself on stdout with one machine-readable line::

    PT_REPLICA_READY {"url": ..., "port": ..., "pid": ..., "version": ...,
                      "model_dir": ..., "device": ...}

(a decode replica adds ``"decode": true`` and its ``"role"``); a
predictor replica with no verified model prints ``PT_REPLICA_FAIL`` and
exits 2.

which is the only contract serving/cluster.py parses. SIGTERM/SIGINT
drain the queue and exit 0; SIGKILL is the crash the router's failover
and session journal exist for. The process inherits FLAGS_* and
PT_FAULT_SPEC / PT_FAULT_SEED from its environment, so a chaos run arms
``decode.step`` / ``replica.swap`` in every replica without code
changes.

``--telemetry-log PATH`` points the process's JSONL run-log sink at
PATH (``telemetry.configure``): the engines' counters, timers and
gauges with their attributes, the sampled spans, and the incidents
land there, and a graceful exit flushes it with a final snapshot.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def _journal_sink(url: str):
    """A journal sink that POSTs each batch of session records to the
    router (``/v1/session/journal``). Short timeout: a slow router must
    never stall the decode step; the engine counts a failure in
    ``session.journal_errors``."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(url)
    path = u.path or "/v1/session/journal"

    def sink(records):
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=2.0)
        try:
            conn.request("POST", path,
                         body=json.dumps({"records": records}).encode(),
                         headers={"Content-Type": "application/json"})
            conn.getresponse().read()
        finally:
            conn.close()

    return sink


def run_decode_replica(args) -> int:
    """One generative replica: DecodeEngine over a decoder-LM servable dir
    behind the HTTP server, with the PT_REPLICA_READY / SIGTERM-drain
    contract."""
    from ..core import telemetry
    from .decode import DecodeConfig, decode_engine_from_dir
    from .server import ServingHTTPServer

    if args.telemetry_log:
        telemetry.configure(args.telemetry_log)
    config = None
    if args.role != "unified" or args.prefill_urls or args.prefix_cache:
        config = DecodeConfig(role=args.role,
                              prefill_urls=args.prefill_urls,
                              prefix_cache=args.prefix_cache or None)
    engine = decode_engine_from_dir(args.decode_model_dir, config=config,
                                    device=args.device)
    if args.journal_url:
        engine.journal_sink = _journal_sink(args.journal_url)
    server = ServingHTTPServer(None, host=args.host, port=args.port,
                               decode_engine=engine).start()
    print("PT_REPLICA_READY " + json.dumps(
        {"url": server.url, "port": server.port, "pid": os.getpid(),
         "version": engine.version, "model_dir": args.decode_model_dir,
         "decode": True, "role": engine.config.role,
         "device": str(engine.device)}), flush=True)

    stop = threading.Event()

    def _graceful(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    engine.start(warmup=True)
    try:
        stop.wait()
    finally:
        engine.close(drain=True, timeout=30)
        server.shutdown()
        telemetry.flush()
    return 0


def run_replica(args) -> int:
    """One predictor replica: a ServingEngine over the newest verified
    published version (``--model-root``) or a bare dir (``--model-dir``)
    behind the HTTP server, with the PT_REPLICA_READY / SIGTERM-drain
    contract."""
    from .. import checkpoint as ckpt
    from ..core import telemetry
    from ..inference import AnalysisConfig, create_predictor
    from .engine import ServingConfig, ServingEngine
    from .server import ServingHTTPServer

    if args.telemetry_log:
        telemetry.configure(args.telemetry_log)
    version = 0
    watcher = None
    if args.model_root:
        watcher = ckpt.ModelWatcher(args.model_root)
        newest = watcher.poll()
        if newest is None:
            print(f"PT_REPLICA_FAIL no verified published model under "
                  f"{args.model_root}", flush=True)
            return 2
        version, model_dir = newest
    else:
        model_dir = args.model_dir
    cfg = ServingConfig(
        max_batch_size=args.max_batch_size or None,
        batch_timeout_ms=args.batch_timeout_ms
        if args.batch_timeout_ms >= 0 else None)
    engine = ServingEngine(create_predictor(AnalysisConfig(model_dir),
                                            device=args.device),
                           config=cfg, version=version)
    server = ServingHTTPServer(engine, host=args.host,
                               port=args.port).start()
    # announce before the warm-up: the controller learns the port at once
    # and watches /healthz flip from "starting" to "ok"
    print("PT_REPLICA_READY " + json.dumps(
        {"url": server.url, "port": server.port, "pid": os.getpid(),
         "version": version, "model_dir": model_dir,
         "device": str(engine.predictor.device)}), flush=True)

    stop = threading.Event()

    def _graceful(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    engine.start(warmup=not args.no_warmup)
    try:
        while not stop.wait(args.poll_s if args.poll_s > 0 else 1.0):
            if watcher is not None and args.poll_s > 0:
                # self-watching (no controller): swap in place when a
                # newer verified version lands
                newest = watcher.poll()
                if newest is not None:
                    v, path = newest
                    try:
                        pred = create_predictor(AnalysisConfig(path),
                                                device=args.device)
                        engine.swap_predictor(pred, version=v)
                        print(f"PT_REPLICA_SWAPPED {v}", flush=True)
                    except Exception as e:
                        print(f"PT_REPLICA_SWAP_FAIL {v} {e!r}", flush=True)
    finally:
        engine.close(drain=True, timeout=30)
        server.shutdown()
        telemetry.flush()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="one serving replica process (serving/cluster.py "
                    "launches these; standalone use works too)")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--model-root",
                     help="published-models root (checkpoint.publish_model "
                          "layout): serves the newest verified version")
    src.add_argument("--model-dir",
                     help="bare inference-model dir (io.save_inference_"
                          "model layout), served as version 0")
    src.add_argument("--decode-model-dir",
                     help="decoder-LM servable dir (save_decoder_lm "
                          "layout): POST /v1/generate through the "
                          "continuous-batching decode engine")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 binds an ephemeral port (announced on stdout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine: 'cuda' (cuda:0, "
                         "the default; raises without CUDA) or 'cpu' "
                         "(the kernels' plain versions)")
    ap.add_argument("--max-batch-size", type=int, default=0,
                    help="0 = FLAGS_serving_max_batch_size")
    ap.add_argument("--batch-timeout-ms", type=float, default=-1.0,
                    help="< 0 = FLAGS_serving_batch_timeout_ms")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--poll-s", type=float, default=0.0,
                    help="> 0 makes a --model-root replica watch the root "
                         "itself and swap to each new version; the "
                         "cluster controller leaves it 0 and swaps over "
                         "/v1/admin/swap")
    ap.add_argument("--role", default="unified",
                    choices=("unified", "prefill", "decode"),
                    help="disaggregated-serving tier (serving/disagg.py): "
                         "'prefill' ships KV pages over POST /v1/prefill, "
                         "'decode' installs them, 'unified' does both "
                         "locally")
    ap.add_argument("--prefill-urls", default="",
                    help="comma-separated prefill-tier URLs (or the "
                         "router's) a decode-role replica fetches KV "
                         "shipments from")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the content-addressed prefix store "
                         "(serving/prefix_store.py)")
    ap.add_argument("--journal-url", default="",
                    help="router endpoint the replica posts session "
                         "journals to (ROUTER_URL/v1/session/journal); "
                         "empty disables journaling")
    ap.add_argument("--telemetry-log", default="",
                    help="JSONL run-log path of this process (the "
                         "telemetry sink; render with tools/perf_report.py)")
    args = ap.parse_args(argv)
    if args.decode_model_dir:
        return run_decode_replica(args)
    return run_replica(args)


if __name__ == "__main__":
    sys.exit(main())
