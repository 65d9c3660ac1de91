"""StatRegistry: STAT_ADD-style counters (port of
``paddle_tpu/core/monitor.py``).

A thin shim over ``core.telemetry``'s counter table, so these stats also
land in the JSONL run log and ``tools/perf_report.py``'s summaries. The
reference adds its native data feed's counters to ``stats()``; that
loader is ROADMAP A9, so ``stats()`` here is the counter table alone.
"""

from __future__ import annotations

from typing import Dict

from . import telemetry


class StatRegistry:
    _instance = None

    @classmethod
    def instance(cls) -> "StatRegistry":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def add(self, name: str, delta: int) -> int:
        return int(telemetry.counter_add(name, int(delta)))

    def set(self, name: str, value: int):
        telemetry.counter_set(name, int(value))

    def get(self, name: str) -> int:
        return int(telemetry.counter_get(name))

    def stats(self) -> Dict[str, int]:
        return telemetry.counters()


def stat_add(name: str, delta: int) -> int:
    """STAT_ADD."""
    return StatRegistry.instance().add(name, delta)


def stat_get(name: str) -> int:
    return StatRegistry.instance().get(name)
