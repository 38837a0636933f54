"""Multi-process job launcher: ``python -m spark_rapids_ml_tpu_torch.launch``.

Counterpart of the JAX package's ``launch.py``. The reference has no
launcher: Spark starts executors and each JVM joins the job implicitly
(``spark.executor.resource.gpu.*``). Here the glue is explicit: start N
processes on this host (or one process of a job spread over hosts), each of
which calls ``parallel.multihost.initialize_multihost()`` and joins the
job's process group, after which the fits' collectives span every rank.

Each child gets ``SPARK_RAPIDS_ML_TORCH_COORDINATOR`` / ``_NUM_PROCESSES`` /
``_PROCESS_ID`` and ``LOCAL_RANK`` (its card on this host: the process id
when every rank runs here, 0 with ``--node-rank``, one process per host).

Usage (4 ranks on this host's CPU over gloo):

    python -m spark_rapids_ml_tpu_torch.launch --nprocs 4 \
        --env SPARK_RAPIDS_ML_TORCH_PLATFORM=cpu script.py arg1 arg2

One rank per card of a 4-card host: ``--nprocs 4 script.py``. One process
per host: ``--nprocs <hosts> --node-rank <i> --coordinator <host0>:<port>``
on every host.

Fail fast: when a child exits non-zero, the others are terminated (a rank
left behind would wait in its collectives until the group's timeout) and
the launcher returns that child's code.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

from spark_rapids_ml_tpu_torch.parallel.multihost import (
    _ENV_COORD,
    _ENV_LOCAL_RANK,
    _ENV_NPROC,
    _ENV_PID,
)

# how long terminated children get to exit before they are killed
_TERMINATE_GRACE_S = 10.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + _TERMINATE_GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="spark_rapids_ml_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--nprocs", type=int, required=True,
                    help="total number of processes in the job")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (default: local, free port)")
    ap.add_argument("--node-rank", type=int, default=None,
                    help="launch only this process id (one process per "
                    "host); default launches all nprocs locally")
    ap.add_argument("--env", action="append", default=[],
                    help="extra KEY=VALUE env for the children (repeatable)")
    ap.add_argument("script", help="python script to run in each process")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)

    if ns.node_rank is not None and ns.coordinator is None:
        # a per-host random local port can never rendezvous across hosts
        ap.error("--node-rank requires --coordinator (host0's host:port)")
    coord = ns.coordinator or f"127.0.0.1:{_free_port()}"
    for kv in ns.env:
        if "=" not in kv:
            ap.error(f"--env expects KEY=VALUE, got {kv!r}")
    extra = dict(kv.split("=", 1) for kv in ns.env)
    ranks = [ns.node_rank] if ns.node_rank is not None else range(ns.nprocs)

    procs = []
    for pid in ranks:
        env = dict(os.environ)
        env.update(extra)
        env[_ENV_COORD] = coord
        env[_ENV_NPROC] = str(ns.nprocs)
        env[_ENV_PID] = str(pid)
        env[_ENV_LOCAL_RANK] = "0" if ns.node_rank is not None else str(pid)
        procs.append(
            subprocess.Popen([sys.executable, ns.script, *ns.args], env=env)
        )

    rc = 0
    try:
        live = list(procs)
        while live and rc == 0:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0:
                    rc = code
            if live and rc == 0:
                time.sleep(0.05)
    except KeyboardInterrupt:
        rc = 130
    finally:
        _stop(procs)
    return rc


if __name__ == "__main__":
    sys.exit(main())
