"""Decode-session journal: the state a generation needs to survive the
death of the replica running it (port of ``paddle_tpu/serving/session.py``).

A decode replica is pure state: its KV pages can be rebuilt from the
token ids, and sampling is a pure function of (the logits, the request's
``RandomState``). So the only durable facts a generation owns are small
and live on the host: the prompt, the accepted token ids, the sampler's
RNG state after those draws, and the deadline's remainder. This module
is that record (``DecodeEngine`` writes one per journaled request at the
step boundary, every ``decode_journal_stride`` accepted tokens, to its
``journal_sink``) and the store a router keeps of them.

To resume, a caller submits ``resume_args(record)`` (its ``prompt_ids``
as the prompt, the rest as keywords): prompt + accepted as the new
prefill, the RNG state restored as it was, ``max_new_tokens``
less the accepted count. The resumed tail follows the accepted tokens:
the two together are the uninterrupted stream. The router does this over
HTTP (serving/router.py ``route_generate``), with the records that decode
replicas post to its ``/v1/session/journal``.

The record's fields and ``pack_rng_state``'s list are the reference's,
so a record written by either package resumes in the other.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import telemetry
from ..core.flags import flag as _flag


def pack_rng_state(rng: Optional[np.random.RandomState]) -> Optional[list]:
    """np.random.RandomState -> JSON-able state: [name, the 624 MT19937
    key words as ints, pos, has_gauss, cached_gaussian]."""
    if rng is None:
        return None
    name, key, pos, has_gauss, cached = rng.get_state()
    return [str(name), [int(x) for x in key], int(pos), int(has_gauss),
            float(cached)]


def unpack_rng_state(state) -> Optional[np.random.RandomState]:
    """Inverse of pack_rng_state; None passes through (a greedy session
    journals no RNG)."""
    if state is None:
        return None
    name, key, pos, has_gauss, cached = state
    rng = np.random.RandomState()
    rng.set_state((str(name), np.asarray(key, np.uint32), int(pos),
                   int(has_gauss), float(cached)))
    return rng


def resume_args(record: Dict[str, Any]) -> Dict[str, Any]:
    """Journal record -> the arguments of the submit that resumes it, as
    the reference's router sends them: ``prompt_ids`` is
    ``DecodeEngine.submit``'s prompt, every other key one of its keywords.
    The resumed request generates only the REMAINING tokens; the caller
    puts ``record['accepted']`` in front of them."""
    accepted = [int(t) for t in record.get("accepted", [])]
    out = {
        "prompt_ids": [int(t) for t in record["prompt"]],
        "prior_tokens": accepted,
        "max_new_tokens": int(record["max_new_total"]) - len(accepted),
        "temperature": float(record.get("temperature", 0.0)),
        "seed": record.get("seed"),
        "rng_state": record.get("rng_state"),
        "stop_at_eos": bool(record.get("stop_at_eos", True)),
        "request_id": record.get("request_id"),
    }
    rem = record.get("deadline_remaining_ms")
    if rem is not None:
        out["deadline_ms"] = max(1.0, float(rem))
    return out


class SessionJournal:
    """The latest record per request id, bounded LRU
    (``router_session_capacity``): completed sessions are popped by the
    caller, abandoned ones age out at the bound (``session.evicted``)."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = int(_flag("router_session_capacity")
                            if capacity is None else capacity)
        self._records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()

    def update(self, records: List[Dict[str, Any]]) -> int:
        """Install a batch of records (one engine step's). A record with
        fewer accepted tokens than the stored one is a late duplicate
        from an earlier life of the request and is dropped: the journal
        only moves forward. Returns the records installed."""
        n = 0
        with self._lock:
            for rec in records:
                rid = rec.get("request_id")
                if not rid:
                    continue
                old = self._records.get(rid)
                if old is not None and (len(old.get("accepted", ()))
                                        > len(rec.get("accepted", ()))):
                    continue
                self._records[rid] = rec
                self._records.move_to_end(rid)
                n += 1
            while self.capacity > 0 and len(self._records) > self.capacity:
                self._records.popitem(last=False)
                telemetry.counter_add("session.evicted", 1)
        if n:
            telemetry.counter_add("session.journaled", n)
        return n

    def get(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._records.get(request_id)
            return dict(rec) if rec is not None else None

    def pop(self, request_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._records.pop(request_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)
