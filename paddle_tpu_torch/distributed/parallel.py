"""The parallel environment (port of ``paddle_tpu/distributed/
parallel.py`` ``init_parallel_env``), for one process: the port trains on
one device."""

from __future__ import annotations

import os


def init_parallel_env() -> bool:
    """Nothing to set up for one process (returns False, as the reference
    does for a single-host run). A launcher's world of more than one
    trainer (``PADDLE_TRAINERS_NUM``) raises: data parallelism is not in
    the port (ROADMAP A8)."""
    nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)
    if nprocs > 1:
        raise NotImplementedError(
            f"a parallel environment of {nprocs} trainers is not in the "
            f"port (one process, one device): ROADMAP A8")
    return False
