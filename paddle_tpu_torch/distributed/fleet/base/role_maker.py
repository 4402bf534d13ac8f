"""Role makers: who this process is in the job (counterpart of
``paddle_tpu/distributed/fleet/base/role_maker.py``; reference
role_maker.py:548, ``PaddleCloudRoleMaker`` reading the launcher's
``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM`` /
``PADDLE_TRAINER_ENDPOINTS``). The parameter-server roles
(``TRAINING_ROLE=PSERVER``, ``PADDLE_PSERVERS_IP_PORT_LIST``) are read
so that ``fleet.init`` can refuse them."""
from __future__ import annotations

import os

from ... import env


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective
        self._training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
        eps = os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST", "")
        self._server_endpoints = [e for e in eps.split(",") if e]
        if self._server_endpoints:
            self._is_collective = False

    def _worker_index(self):
        return env.get_rank()

    def _worker_num(self):
        return env.get_world_size()

    def _is_first_worker(self):
        return self._worker_index() == 0

    def _role(self):
        return Role.SERVER if self.is_server() else Role.WORKER

    worker_index = _worker_index
    worker_num = _worker_num
    is_first_worker = _is_first_worker

    def _get_trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return [e for e in eps.split(",") if e]

    def is_worker(self):
        return not self.is_server()

    def is_server(self):
        return self._training_role == "PSERVER"


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """A role maker with the role and the ranks given, not read: the JAX
    package's positional order ``(is_collective, current_id, role,
    worker_num, server_endpoints)`` (``paddle_tpu/distributed/fleet/
    compat.py:25``); ``worker_index`` is ``current_id`` and
    ``worker_num`` the given count."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=1, server_endpoints=None, **kwargs):
        super().__init__(is_collective=is_collective)
        self._current_id = int(current_id)
        self._worker_count = int(worker_num)
        self._training_role = "PSERVER" if role == Role.SERVER else "TRAINER"
        self._server_endpoints = list(server_endpoints or [])
        if self._server_endpoints:
            self._is_collective = False
        self._worker_endpoints = list(kwargs.get("worker_endpoints") or [])

    def _worker_index(self):
        return self._current_id

    def _worker_num(self):
        return self._worker_count

    def _is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    worker_index = _worker_index
    worker_num = _worker_num
    is_first_worker = _is_first_worker
