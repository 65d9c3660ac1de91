"""The admission queue's depth gauge after a submit that races a take
(``serving/admission.py``): the gauge is written under the queue's lock,
so the last value written is the depth the queue has. Before, a submit
wrote its depth after releasing the lock; a decode loop that polled the
request in between wrote 0 first, and the submit's stale 1 stayed on an
empty queue, where the SLO watchdog's queue-depth rule read it
(chip_smoke's ``observe_serve_int8`` saw an incident trip during its
probe request, with no finished trace to name)."""

import threading

from paddle_tpu_torch.core import telemetry
from paddle_tpu_torch.serving import admission
from paddle_tpu_torch.serving.admission import AdmissionQueue


def test_a_take_during_submit_leaves_the_queue_s_own_depth(monkeypatch):
    q = AdmissionQueue(8, metric_prefix="gaugetest")
    real = admission.telemetry.gauge_set
    taken, takers = [], []

    def gauge_set(name, value, **attrs):
        if value == 1 and not takers:
            # a taker runs while the submit is writing its depth; it
            # finishes first unless the submit still holds the lock
            takers.append(threading.Thread(
                target=lambda: taken.extend(q.poll(8))))
            takers[0].start()
            takers[0].join(timeout=0.3)
        real(name, value, **attrs)

    monkeypatch.setattr(admission.telemetry, "gauge_set", gauge_set)
    q.submit({}, 1)
    takers[0].join(timeout=5)
    assert not takers[0].is_alive() and len(taken) == 1
    assert telemetry.gauges()["gaugetest.queue_depth"] == 0
