"""Start the processes of a mesh on one host.

The dryrun (``scripts/dcn_dryrun.py``), the tests and the card smoke run a
mesh over several processes of one machine: each worker joins the default
``torch.distributed`` group through a file store (no TCP port that a
parallel run could take) and builds the world mesh with
``parallel/mesh.build_mesh``, and leaves it with ``leave`` when done.
``run`` starts the workers together and
waits for them: a worker that fails, or the deadline, ends every worker, so
no process is left waiting in a collective.
"""

from __future__ import annotations

import os
import subprocess
import time
from datetime import timedelta
from typing import List, Sequence, Tuple

import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def join(store: str, rank: int, world: int, timeout_s: float = 300.0) -> None:
    """Join the default gloo process group of `world` ranks as `rank`
    through the file store at path `store` (the same path in every worker,
    a file no earlier group used).  A collective that waits longer than
    `timeout_s` raises.  (An NCCL group, one rank a card, is joined with
    ``init_process_group`` itself; ProcessTransport reads the backend from
    the group.)"""
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.abspath(store)}", world_size=world, rank=rank,
        timeout=timedelta(seconds=timeout_s),
    )


def leave() -> None:
    """Leave the group once every rank is done: a barrier, then the group
    destroyed (a gloo group left to the interpreter's exit can abort the
    process after its work is done)."""
    dist.barrier()
    dist.destroy_process_group()


def worker_env() -> dict:
    """The environment of a worker: this checkout importable, and gloo on
    the loopback interface (every peer is on this host)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["GLOO_SOCKET_IFNAME"] = "lo"
    return env


def run(commands: Sequence[Sequence[str]], logs: Sequence[str], timeout_s: float) -> List[Tuple[int, str]]:
    """Run one worker a command, all at once, in worker_env(), each writing
    its output to its log file; wait until all end or `timeout_s` passes.
    When a worker fails or time runs out, the others are killed.  Returns
    (exit code, output) a worker; a killed worker's code is negative."""
    env = worker_env()
    files = [open(path, "w") for path in logs]
    try:
        procs = [subprocess.Popen(list(cmd), env=env, stdout=f, stderr=subprocess.STDOUT) for cmd, f in zip(commands, files)]
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = any(p.poll() not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                break
            time.sleep(0.05)
    finally:
        for f in files:
            f.close()
    out = []
    for p, path in zip(procs, logs):
        with open(path) as f:
            out.append((p.returncode, f.read()))
    return out
