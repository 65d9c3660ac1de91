"""Deterministic fault injection (port of ``paddle_tpu/core/faults.py``).

A process-global registry of named injection sites consulted by the
serving hot paths, driven by a spec string so chaos runs need no code
changes. The sites of the port's generative plane are the reference's,
at the same places: ``decode.step`` (the decode engine's step,
serving/decode.py), ``decode.kv_alloc`` (the KV page allocator,
serving/kv_cache.py), ``kv.prefix_lookup`` (the prefix store's lookup,
serving/prefix_store.py), ``disagg.ship`` (a prefill-tier shipment,
serving/decode.py), ``router.dispatch`` (each router attempt,
serving/router.py), ``serving.handler`` (each micro-batch,
serving/engine.py) and ``replica.swap`` (a model swap,
serving/engine.py). The spec grammar::

    FLAGS_fault_spec / PT_FAULT_SPEC =
        clause [ (','|';') clause ]*
    clause  = site ':' trigger [ ':' ExcName ]
    trigger = float p in (0, 1]   fire each call with probability p
            | '@' N               fire exactly on the Nth call (once)
            | '%' N               fire on every Nth call
    ExcName defaults to ConnectionError; resolved from builtins, then
    the serving plane's typed errors (serving/admission.py).

Every probabilistic rule owns a ``random.Random`` seeded from
(FLAGS_fault_seed, site, rule index), so the fire pattern is a pure
function of the seed and the per-site call sequence. Every injected
fault bumps ``faults.injected`` and records a ``fault`` event. The
registry re-reads the spec flag on use, so ``configure`` (or
``flags.set_flags``) takes effect mid-run; an empty spec keeps
``maybe_fail`` at a dict lookup. The registry's lock is a plain
``threading.Lock`` (the reference's lockdep-checked locks are ROADMAP
A10b).
"""

from __future__ import annotations

import os
import random
import threading
from typing import Any, Dict, List, Optional

from . import flags as _flags
from . import telemetry


class FaultSpecError(ValueError):
    """Malformed FLAGS_fault_spec / PT_FAULT_SPEC string."""


def _resolve_exc(name: str):
    import builtins

    exc = getattr(builtins, name, None)
    if exc is None:
        from ..serving import admission as _adm

        exc = getattr(_adm, name, None)
    if not (isinstance(exc, type) and issubclass(exc, BaseException)):
        raise FaultSpecError(f"unknown exception type '{name}' in fault "
                             f"spec (builtins + serving.admission)")
    return exc


class _Rule:
    __slots__ = ("site", "prob", "nth", "every", "exc", "rng", "spent")

    def __init__(self, site: str, trigger: str, exc_name: str,
                 seed: int, index: int):
        self.site = site
        self.prob: Optional[float] = None
        self.nth: Optional[int] = None
        self.every: Optional[int] = None
        self.exc = _resolve_exc(exc_name or "ConnectionError")
        self.spent = False
        # per-rule stream: (seed, site, index) so rules never share draws
        self.rng = random.Random(f"{seed}|{site}|{index}")
        if trigger.startswith("@"):
            self.nth = int(trigger[1:])
            if self.nth < 1:
                raise FaultSpecError(f"'@N' trigger needs N >= 1: {trigger}")
        elif trigger.startswith("%"):
            self.every = int(trigger[1:])
            if self.every < 1:
                raise FaultSpecError(f"'%N' trigger needs N >= 1: {trigger}")
        else:
            self.prob = float(trigger)
            if not 0.0 < self.prob <= 1.0:
                raise FaultSpecError(
                    f"probability trigger must be in (0, 1]: {trigger}")

    def fires(self, call_index: int) -> bool:
        """call_index is the 1-based count of calls at this rule's site."""
        if self.nth is not None:
            if self.spent or call_index != self.nth:
                return False
            self.spent = True
            return True
        if self.every is not None:
            return call_index % self.every == 0
        return self.rng.random() < self.prob


def _parse(spec: str, seed: int) -> List[_Rule]:
    rules: List[_Rule] = []
    for idx, clause in enumerate(
            c.strip() for part in spec.split(";")
            for c in part.split(",")):
        if not clause:
            continue
        bits = clause.split(":")
        if len(bits) == 2:
            site, trigger, exc = bits[0], bits[1], ""
        elif len(bits) == 3:
            site, trigger, exc = bits
        else:
            raise FaultSpecError(
                f"fault clause '{clause}' is not site:trigger[:Exc]")
        if not site:
            raise FaultSpecError(f"empty site in fault clause '{clause}'")
        rules.append(_Rule(site, trigger, exc, seed, idx))
    return rules


class FaultRegistry:
    _instance: Optional["FaultRegistry"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: Dict[str, List[_Rule]] = {}
        self._calls: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}
        self._src: Optional[tuple] = None

    @classmethod
    def instance(cls) -> "FaultRegistry":
        if cls._instance is None:
            with cls._instance_lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    # -- spec tracking -------------------------------------------------------
    @staticmethod
    def _effective_spec() -> tuple:
        spec = _flags.flag("fault_spec") or \
            os.environ.get("PT_FAULT_SPEC", "")
        seed = _flags.flag("fault_seed")
        if seed == 0:
            seed = int(os.environ.get("PT_FAULT_SEED", "0") or 0)
        return spec.strip(), int(seed)

    def _sync(self):
        """(Re)parse when the flag/env spec changed — called under
        self._lock. A spec change resets call counts so nth-call rules
        are reproducible from the moment of configuration."""
        src = self._effective_spec()
        if src == self._src:
            return
        spec, seed = src
        # parse BEFORE committing _src: a malformed spec keeps raising on
        # every use (loud) instead of erroring once and going silent
        parsed = _parse(spec, seed) if spec else []
        self._src = src
        self._calls.clear()
        self._injected.clear()
        self._rules = {}
        for rule in parsed:
            self._rules.setdefault(rule.site, []).append(rule)

    # -- the injection point -------------------------------------------------
    def maybe_fail(self, site: str, **attrs: Any):
        """Raise the configured fault for `site`, if any rule fires.
        Every call counts against the site's 1-based call index whether
        or not a rule exists (so '@N' specs configured mid-run still
        reference the site's true call history from config time)."""
        with self._lock:
            self._sync()
            if not self._rules:
                return
            rules = self._rules.get(site)
            if not rules:
                return
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            fired = None
            for rule in rules:
                if rule.fires(n):
                    fired = rule
                    break
            if fired is None:
                return
            self._injected[site] = self._injected.get(site, 0) + 1
        exc_name = fired.exc.__name__
        telemetry.counter_add("faults.injected", 1, site=site, exc=exc_name,
                              **attrs)
        telemetry.event("fault", site, self._injected.get(site),
                        {"exc": exc_name, **attrs})
        raise fired.exc(f"injected fault at {site} (call {n})")

    # -- introspection / test control ----------------------------------------
    def active(self) -> bool:
        with self._lock:
            self._sync()
            return bool(self._rules)

    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"calls": dict(self._calls),
                    "injected": dict(self._injected)}

    def reset(self):
        """Forget call history and force a reparse on next use."""
        with self._lock:
            self._src = None
            self._rules = {}
            self._calls.clear()
            self._injected.clear()


# -- module-level surface ----------------------------------------------------

def _reg() -> FaultRegistry:
    return FaultRegistry.instance()


def maybe_fail(site: str, **attrs):
    return _reg().maybe_fail(site, **attrs)


def active() -> bool:
    return _reg().active()


def counts() -> Dict[str, Dict[str, int]]:
    return _reg().counts()


def reset():
    return _reg().reset()


def configure(spec: Optional[str], seed: Optional[int] = None):
    """Install a fault spec (None/'' disables) + optional seed, resetting
    call history — the programmatic twin of FLAGS_fault_spec /
    PT_FAULT_SPEC."""
    _flags.set_flags({"fault_spec": spec or ""})
    if seed is not None:
        _flags.set_flags({"fault_seed": int(seed)})
    _reg().reset()
    _reg().active()   # eager validation: a bad spec raises HERE
