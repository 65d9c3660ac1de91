"""Generative serving on PyTorch: the decode engine over a paged KV
cache, prefix sharing, session journaling and KV page shipments (port of
``paddle_tpu.serving``'s decode path)."""

from .admission import (DeadlineExceededError, EngineClosedError,  # noqa: F401
                        KVCacheExhaustedError, ServerOverloadedError,
                        ServingError)
from .decode import (DecodeConfig, DecodeEngine,  # noqa: F401
                     GenerationRequest, ShipPrefillRequest,
                     decode_engine_from_dir)
from .disagg import (ShipmentCRCError, ShipmentError,  # noqa: F401
                     pack_shipment, unpack_shipment)
from .kv_cache import KVPagePool  # noqa: F401
from .prefix_store import PrefixStore, prefix_chain_hash  # noqa: F401
from .session import (SessionJournal, pack_rng_state,  # noqa: F401
                      resume_args, unpack_rng_state)
