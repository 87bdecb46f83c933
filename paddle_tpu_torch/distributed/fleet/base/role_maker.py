"""Role makers: who this process is in the job (counterpart of
``paddle_tpu/distributed/fleet/base/role_maker.py``).

Roles come from the launcher's environment (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS``), as Paddle's
``PaddleCloudRoleMaker`` reads them. There is no parameter-server tier:
every process is a collective worker.
"""
from __future__ import annotations

import os

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return False  # no PS tier in this build

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_index(self):
        raise NotImplementedError

    def worker_num(self):
        raise NotImplementedError

    def role_id(self):
        return self.worker_index()


class PaddleCloudRoleMaker(RoleMakerBase):
    """Environment-driven role maker (the launcher exports the same
    variables the reference's cloud runtime does)."""

    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective

    def worker_index(self):
        return int(os.environ.get("PADDLE_TRAINER_ID", 0))

    def worker_num(self):
        return int(os.environ.get("PADDLE_TRAINERS_NUM", 1))

    def worker_endpoints(self, to_string=False):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        lst = [e for e in eps.split(",") if e]
        return ",".join(lst) if to_string else lst


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, current_id=0, role=Role.WORKER,
                 worker_num=1, worker_endpoints=None, **kwargs):
        super().__init__()
        self._role = role
        self._current_id = int(current_id)
        self._worker_num = int(worker_num)
        self._endpoints = list(worker_endpoints or [])

    def worker_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def worker_endpoints(self, to_string=False):
        return (",".join(self._endpoints) if to_string
                else list(self._endpoints))
