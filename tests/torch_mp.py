"""Runs a job of ``tests/torch_mp_worker.py`` on n gloo ranks, one process
each, on the CPU: the ranks meet at a free localhost port, every rank writes
its result to ``<out>/rank<r>.pt``, and the launcher joins them under one
timeout, kills every rank on expiry and fails the test, so that a rank
stuck in a collective never holds up the run. Each rank dumps its stacks
into its log shortly before the timeout (``torch_mp_worker.DUMP_MARGIN``),
and the failure shows the logs' ends."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_mp_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(job: str, n: int, out: Path, timeout: float = 120.0):
    """``job`` on ``n`` ranks; returns [rank 0's result, rank 1's, ...]."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    for rank in range(n):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), job, str(rank), str(n), str(port), str(out),
             str(timeout)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(HERE.parent)), log))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            if time.monotonic() > deadline:
                pytest.fail(f"{job} on {n} ranks: not done after {timeout:.0f} s\n"
                            + _logs(out, n))
            if any(p.poll() not in (None, 0) for p, _ in procs):
                time.sleep(1.0)  # let the others fail on their own, then stop them
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    if any(codes):
        pytest.fail(f"{job} on {n} ranks: exit codes {codes}\n" + _logs(out, n))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _logs(out, n):
    return "\n".join(f"--- rank {r} ---\n" + (out / f"rank{r}.log").read_text()[-3000:]
                     for r in range(n))
