"""Replica health: the liveness/readiness distinction a router routes on
(port of ``paddle_tpu/serving/health.py``, whole).

*Liveness* ("the process is up and its loop can still make progress") and
*readiness* ("route traffic here NOW") are different questions. A replica
warming its programs is alive but not ready; a replica draining its queue
for shutdown, or swapping model versions, is alive, still answering
in-flight work, but must stop receiving new requests:

    STARTING --start()+warmup--> READY
    READY    --swap begins-----> SWAPPING --swap done--> READY
    READY    --close()---------> DRAINING --joined-----> STOPPED

Readiness is READY only; liveness is everything but STOPPED. The HTTP
server maps readiness to ``/healthz`` (200 ``{"status": "ok"}`` / 503
``{"status": "starting"|"swapping"|"draining"|"stopped"}``) and liveness
to ``/livez``. State flips are announced on the ``serving.ready`` gauge
(0/1) and counted in ``serving.health_transitions``. The lock is a plain
``threading.Lock`` (lockdep is ROADMAP A10b).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ..core import telemetry

STARTING = "starting"
READY = "ok"            # the wire string /healthz always reported when up
SWAPPING = "swapping"
DRAINING = "draining"
STOPPED = "stopped"

_LIVE = (STARTING, READY, SWAPPING, DRAINING)


class HealthState:
    """Thread-safe replica health: one current state + transition log."""

    def __init__(self, state: str = STARTING, name: str = ""):
        self._lock = threading.Lock()
        self._state = state
        self._since = time.time()
        self.name = name

    # -- transitions ---------------------------------------------------------
    def set(self, state: str):
        with self._lock:
            if state == self._state:
                return
            prev, self._state = self._state, state
            self._since = time.time()
        telemetry.gauge_set("serving.ready", 1 if state == READY else 0)
        telemetry.counter_add("serving.health_transitions", 1,
                             frm=prev, to=state, replica=self.name)

    # -- queries -------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def is_ready(self) -> bool:
        return self.state == READY

    def is_alive(self) -> bool:
        return self.state in _LIVE

    def snapshot(self, **extra: Any) -> Dict[str, Any]:
        with self._lock:
            state, since = self._state, self._since
        out = {"status": state, "ready": state == READY,
               "alive": state in _LIVE,
               "since_s": round(time.time() - since, 3)}
        out.update(extra)
        return out


class ReadyGate:
    """Scoped not-ready marker: hold a state (SWAPPING/DRAINING) for the
    duration of a block, then restore the entry state — but only if no
    OTHER transition happened meanwhile (a close() arriving mid-swap
    moves to DRAINING/STOPPED and must win; a finished swap must not
    resurrect a draining replica)."""

    def __init__(self, health: HealthState, state: str):
        self.health = health
        self.state = state
        self._was: Optional[str] = None

    def __enter__(self):
        self._was = self.health.state
        self.health.set(self.state)
        return self

    def __exit__(self, et, ev, tb):
        if self.health.state == self.state and self._was is not None:
            self.health.set(self._was)
        return False
