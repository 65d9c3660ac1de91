"""Role makers: who this process is in the cluster (port of
``paddle_tpu/distributed/fleet/role_maker.py``; reference
fleet/base/role_maker.py). ``PaddleCloudRoleMaker`` reads the launcher's
``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``; without them the port is
one process, worker 0 of 1."""

from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def worker_num(self) -> int:
        raise NotImplementedError

    def worker_index(self) -> int:
        raise NotImplementedError

    def is_worker(self) -> bool:
        return True

    def is_server(self) -> bool:
        return False

    def is_first_worker(self) -> bool:
        return self.worker_index() == 0


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "0"))
        self._worker_index = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self._endpoints = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")

    def worker_num(self) -> int:
        return self._worker_num or 1

    def worker_index(self) -> int:
        return self._worker_index if self._worker_num else 0


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id: int = 0, worker_num: int = 1,
                 role=Role.WORKER, **kwargs):
        self._id = current_id
        self._n = worker_num
        self._role = role

    def worker_num(self) -> int:
        return self._n

    def worker_index(self) -> int:
        return self._id

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER
