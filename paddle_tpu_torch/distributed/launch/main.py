"""``python -m paddle_tpu_torch.distributed.launch``: the process
launcher (counterpart of ``paddle_tpu/distributed/launch/main.py``;
reference launch/main.py:23 and controllers/collective.py:22).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py --my-flag

starts ``--nproc_per_node`` processes of the script on this node, rank
``node_rank * nproc_per_node + local_rank`` of ``nnodes * nproc_per_node``,
each with ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``PADDLE_LOCAL_SIZE``, ``PADDLE_MASTER`` (rank
0's store: ``--master`` or a free local port), ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_RESTART_COUNT`` and, with ``--backend``, ``PADDLE_DISTRI_BACKEND``
(``init_parallel_env`` reads them), its output in
``log_dir/workerlog.<rank>``. It watches them as the JAX launcher does
(:64-171): the first rank that fails stops the others (SIGTERM, then a
kill after 10 s); with ``--max_restarts N`` the whole pod is started
again, at the same size, up to N times. The exit code is the failed
rank's (0 when all succeed).

The watchdog heartbeats (``--heartbeat_timeout``), elastic relaunch
(``--elastic_level``) and the rpc / ps modes come with the launcher's
later slice and raise here.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from ..spawn import free_port


def build_parser():
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="launch a distributed training job")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks on this node (one a GPU, or several sharing "
                        "one under gloo)")
    p.add_argument("--master", type=str, default=None,
                   help="host:port of rank 0's store (required if "
                        "nnodes > 1)")
    p.add_argument("--rank", type=int, default=0, help="this node's rank")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--devices", type=str, default=None,
                   help="CUDA_VISIBLE_DEVICES for the ranks")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--backend", type=str, default=None,
                   help="nccl or gloo (default: the backend rule)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="start the pod again after a failure, up to this "
                        "many times")
    p.add_argument("--elastic_level", type=int, default=0)
    p.add_argument("--heartbeat_timeout", type=float, default=0.0)
    p.add_argument("--run_mode", type=str, default="collective")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p


def _check_supported(ns):
    for flag, on, slice_ in (
            ("--elastic_level", ns.elastic_level > 0, "elastic relaunch"),
            ("--heartbeat_timeout", ns.heartbeat_timeout > 0,
             "the watchdog's cross-rank heartbeats"),
            ("--run_mode", ns.run_mode != "collective",
             "the rpc / ps run modes")):
        if on:
            raise SystemExit(
                f"{flag}: {slice_} come(s) with the launcher's later slice "
                f"of the port (ROADMAP D6)")


def _run_pod(ns, master, restart):
    os.makedirs(ns.log_dir, exist_ok=True)
    nproc, world = ns.nproc_per_node, ns.nnodes * ns.nproc_per_node
    host = master.rsplit(":", 1)[0]
    endpoints = ",".join(f"{host}:{int(master.rsplit(':', 1)[1]) + 1 + i}"
                         for i in range(world))
    procs, logs = [], []
    try:
        for local in range(nproc):
            rank = ns.rank * nproc + local
            env = dict(os.environ)
            env.update({
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(world),
                "PADDLE_LOCAL_RANK": str(local),
                "PADDLE_LOCAL_SIZE": str(nproc),
                "PADDLE_MASTER": master,
                "PADDLE_TRAINER_ENDPOINTS": endpoints,
                "PADDLE_JOB_ID": ns.job_id,
                "PADDLE_RESTART_COUNT": str(restart)})
            if ns.backend:
                env["PADDLE_DISTRI_BACKEND"] = ns.backend
            if ns.devices is not None:
                env["CUDA_VISIBLE_DEVICES"] = ns.devices
            path = os.path.join(ns.log_dir, f"workerlog.{rank}")
            if restart:
                path += f".restart{restart}"
            logf = open(path, "w")
            logs.append(logf)
            procs.append(subprocess.Popen(
                [sys.executable, ns.training_script]
                + ns.training_script_args,
                env=env, stdout=logf, stderr=subprocess.STDOUT))
        exit_code, running = 0, list(procs)
        while running and exit_code == 0:
            time.sleep(0.1)
            still = []
            for p in running:
                rc = p.poll()
                if rc is None:
                    still.append(p)
                elif rc != 0:
                    exit_code = rc
            running = still
        if exit_code != 0:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        return exit_code
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()


def launch(args=None) -> int:
    ns = build_parser().parse_args(args)
    _check_supported(ns)
    if ns.nnodes > 1 and not ns.master:
        raise SystemExit("--master host:port is required for nnodes > 1")
    master = ns.master or f"127.0.0.1:{free_port()}"
    restart = 0
    while True:
        code = _run_pod(ns, master, restart)
        if code == 0 or restart >= ns.max_restarts:
            return code
        restart += 1
        print(f"launch: a rank failed (exit {code}); restart {restart}/"
              f"{ns.max_restarts}", flush=True)
        if not ns.master:
            master = f"127.0.0.1:{free_port()}"


def main():
    raise SystemExit(launch())


if __name__ == "__main__":
    main()
