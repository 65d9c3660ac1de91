"""FLAGS registry — env-settable runtime configuration.

The port keeps the part of ``paddle_tpu/core/flags.py`` that this slice
reads: the ``FLAGS_decode_*`` entries behind ``DecodeConfig`` and the
typed bucket-list parser. Each flag has a default and is overridable via
the environment (``FLAGS_<name>=...``) at import.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


class ConfigError(ValueError):
    """Typed configuration-surface error."""


class UnknownFlagError(ConfigError):
    """A flag name that is not in the registry."""


class BucketConfigError(ConfigError):
    """A bucket-boundary list that is not a strictly increasing sequence
    of positive integers (or fails its coverage requirement)."""


class _Flag:
    __slots__ = ("name", "value", "default", "doc", "type")

    def __init__(self, name, default, doc):
        self.name = name
        self.default = default
        self.value = default
        self.doc = doc
        self.type = type(default)


_REGISTRY: Dict[str, _Flag] = {}


def _coerce(f: _Flag, val):
    if f.type is bool:
        if isinstance(val, str):
            return val.lower() in ("1", "true", "yes", "on")
        return bool(val)
    return f.type(val)


def define_flag(name: str, default, doc: str = ""):
    f = _Flag(name, default, doc)
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        f.value = _coerce(f, env)
    _REGISTRY[name] = f
    return f


def flag(name: str):
    if name not in _REGISTRY:
        raise UnknownFlagError(f"unknown flag '{name}'")
    return _REGISTRY[name].value


def parse_buckets(spec, name: str = "buckets",
                  cover: Optional[int] = None,
                  cover_exact: bool = False) -> Optional[List[int]]:
    """Parse + validate a bucket-boundary list (a comma-separated flag
    string or a sequence of ints): positive, strictly increasing, and
    reaching ``cover`` (exactly, with ``cover_exact``). Returns None for
    an empty spec (the caller's default applies)."""
    if spec is None:
        vals: List[int] = []
    else:
        parts = ([b for b in spec.strip().split(",") if b.strip()]
                 if isinstance(spec, str) else spec)
        try:
            vals = [int(b) for b in parts]
        except (TypeError, ValueError) as e:
            raise BucketConfigError(
                f"{name}: non-integer bucket boundary in {spec!r}") from e
    if not vals:
        return None
    if vals[0] < 1:
        raise BucketConfigError(
            f"{name}: bucket boundaries must be >= 1, got {vals}")
    for a, b in zip(vals, vals[1:]):
        if b <= a:
            raise BucketConfigError(
                f"{name}: bucket boundaries must be strictly increasing, "
                f"got {vals}")
    if cover is not None:
        if cover_exact and vals[-1] != cover:
            raise BucketConfigError(
                f"{name}: bucket set {vals} must end exactly at {cover}")
        if vals[-1] < cover:
            raise BucketConfigError(
                f"{name}: bucket set {vals} does not cover {cover}")
    return vals


# -- generative decode engine (serving/decode.py) ---------------------------

define_flag("decode_max_slots", 8,
            "decode-state slots: the most sequences decoded at once; the "
            "step program runs at fixed slot-array shapes")
define_flag("decode_buckets", "",
            "comma-separated slot-array sizes the step pads the active "
            "set up to; empty = ONE bucket of decode_max_slots (fixed "
            "step shape, so continuous == sequential bit for bit)")
define_flag("decode_page_size", 16, "tokens per KV-cache page")
define_flag("decode_kv_pages", 64,
            "pages in the preallocated KV pool (per layer); admission "
            "refuses a request whose worst-case page need can never fit")
define_flag("decode_max_queue_depth", 256,
            "admission bound on queued generation requests")
define_flag("decode_default_deadline_ms", 0.0,
            "per-request generation deadline when the caller gives none; "
            "<= 0 means no deadline")
define_flag("decode_max_new_tokens", 64,
            "default generation budget when a request sets none")
define_flag("decode_weight_quant", "none",
            "'none' serves fp32 weights, 'int8' per-output-channel "
            "weight-only int8 through the int8 GEMM kernel")
define_flag("decode_prefix_cache", False,
            "content-addressed prefix sharing (serving/prefix_store.py): "
            "every prefill runs page-sized chunks through the chunked "
            "prefill program, and a prompt whose leading full pages are "
            "cached replays only its suffix")
define_flag("decode_role", "unified",
            "disaggregated-serving role: 'unified', 'prefill' or "
            "'decode'; validated and reported in stats(), it gates "
            "nothing while fetching a shipment is not in the port "
            "(DecodeEngine.submit_prefill ships under every role)")
define_flag("disagg_prefill_urls", "",
            "prefill-tier URLs for a decode-role replica (fetching a "
            "shipment over HTTP is not in the port yet: a non-empty value "
            "raises NotImplementedError)")
define_flag("decode_journal_stride", 1,
            "session journaling: snapshot each journaled request every N "
            "accepted tokens, at the step boundary, to the engine's "
            "journal_sink (<= 0 disables)")
define_flag("router_session_capacity", 4096,
            "SessionJournal bound: the most session records kept, oldest "
            "evicted first (session.evicted)")
