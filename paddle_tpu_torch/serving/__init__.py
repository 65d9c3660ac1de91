"""Serving on PyTorch (port of ``paddle_tpu.serving``: the micro-batching
plane, the generative decode plane and their cluster plane).

* ``engine.ServingEngine``: dynamic micro-batching over an
  ``inference.AnalysisPredictor`` behind the admission queue, padded to
  buckets, with the zero-downtime ``swap_predictor``;
* ``decode.DecodeEngine``: continuous-batching generation over a paged KV
  cache (``kv_cache``), prefix sharing (``prefix_store``), session
  journaling (``session``), KV page shipments between a prefill and a
  decode tier (``disagg``);
* ``server``: ``serve``, ``serve_decode``, ``LocalClient`` and
  ``ServingHTTPServer``, the HTTP front end (``/v1/infer``,
  ``/v1/admin/swap``, ``/v1/generate``, ``/v1/prefill``, ``/healthz``,
  ``/livez``, ``/v1/stats``, ``/metrics``) with the readiness machine of
  ``health``;
* ``router``: prefix-affinity, failover, dedup, session resumption and
  an online trial's traffic split over the replicas;
  ``RouterHTTPServer`` its front end;
* ``cluster``: ``ClusterController`` launches predictor replicas over a
  published-models root, rolling them onto each new version, or decode
  replicas in tiers (``replica``: ``python -m
  paddle_tpu_torch.serving.replica``), behind a router, respawns the
  ones that die, scales the fleet (``scale_to``, ``scale_tier``, the
  autoscaler over a distributed/scaler.py policy) and retunes one
  replica for an online trial (core/tuner.py).
"""

from .admission import (AdmissionQueue, DeadlineExceededError,  # noqa: F401
                        EngineClosedError, InferenceRequest,
                        KVCacheExhaustedError, ServerOverloadedError,
                        ServingError)
from .cluster import (ClusterController, ClusterError,  # noqa: F401
                      InprocReplica, ReplicaProcess)
from .decode import (DecodeConfig, DecodeEngine,  # noqa: F401
                     GenerationRequest, ShipPrefillRequest,
                     decode_engine_from_dir)
from .engine import ServingConfig, ServingEngine  # noqa: F401
from .disagg import (ShipmentCRCError, ShipmentError,  # noqa: F401
                     fetch_prefill, pack_shipment, unpack_shipment)
from .health import HealthState  # noqa: F401
from .kv_cache import KVPagePool  # noqa: F401
from .prefix_store import PrefixStore, prefix_chain_hash  # noqa: F401
from .router import (NoReplicaAvailableError, ReplicaHandle,  # noqa: F401
                     Router, RouterHTTPServer)
from .server import (LocalClient, ServingHTTPServer, serve,  # noqa: F401
                     serve_decode)
from .session import (SessionJournal, pack_rng_state,  # noqa: F401
                      resume_args, unpack_rng_state)
