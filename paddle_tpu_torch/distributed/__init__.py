"""Distributed (port of ``paddle_tpu/distributed``) for one device: the
fleet front end and its meta-optimizers (``fleet``), the single-process
``init_parallel_env`` and the scale policy (``scaler``)."""

from .parallel import init_parallel_env  # noqa: F401
