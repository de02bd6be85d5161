"""Multi-process launch: torch.distributed init + localhost emulation.

The port's counterpart of the reference's ``launch/distributed.py``.  Two
ways into the same code path:

  * **Real multi-host**: every host runs the same program;
    ``initialize()`` reads the coordinator address / process id / process
    count from the ``REPRO_COORDINATOR`` / ``REPRO_PROCESS_ID`` /
    ``REPRO_NUM_PROCESSES`` environment (or an explicit config) and calls
    ``torch.distributed.init_process_group`` over ``env://``.

  * **Emulation**: ``spawn_emulated(n, argv)`` launches n localhost
    subprocesses of the same worker program with a free-port coordinator
    on 127.0.0.1, so the two-process tests run the identical
    initialize/driver path a real fleet uses.

The collectives backend is gloo: NCCL refuses two ranks on one device,
and only metadata crosses ranks (``distributed.collectives``), staged
through the host.  Importing this module starts nothing.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from repro_torch.faults.retry import Backoff

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
HOST = "127.0.0.1"

# A fleet that died because the coordinator could not bind its probed port
# (the free_port() bind-then-release race) is retried with a fresh port;
# any other failure is real and returned to the caller untouched.
_BIND_FAILURE_MARKERS = ("address already in use", "eaddrinuse",
                         "errno: 98", "failed to bind")


@dataclass(frozen=True)
class DistributedConfig:
    """Where this process sits in the fleet (1-process == no fleet)."""

    coordinator: str = f"{HOST}:0"
    num_processes: int = 1
    process_id: int = 0


def env_config(environ: Optional[Dict[str, str]] = None
               ) -> Optional[DistributedConfig]:
    """Fleet coordinates from the environment; None when not launched as
    part of one."""
    env = os.environ if environ is None else environ
    if ENV_NUM_PROCESSES not in env:
        return None
    return DistributedConfig(
        coordinator=env.get(ENV_COORDINATOR, f"{HOST}:0"),
        num_processes=int(env[ENV_NUM_PROCESSES]),
        process_id=int(env.get(ENV_PROCESS_ID, "0")))


def initialize(cfg: Optional[DistributedConfig] = None, *,
               backend: str = "gloo") -> DistributedConfig:
    """Join the fleet (a no-op for 1-process configs); returns the
    resolved config."""
    if cfg is None:
        cfg = env_config() or DistributedConfig()
    if cfg.num_processes > 1 and not dist.is_initialized():
        host, _, port = cfg.coordinator.rpartition(":")
        os.environ["MASTER_ADDR"] = host or HOST
        os.environ["MASTER_PORT"] = port
        dist.init_process_group(backend, init_method="env://",
                                world_size=cfg.num_processes,
                                rank=cfg.process_id)
    return cfg


def shutdown() -> None:
    """Leave the fleet (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def free_port() -> int:
    """A currently free TCP port for the emulated coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def rank_env(rank: int, num_processes: int, coordinator: str, *,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Child environment for emulated rank `rank`: the fleet coordinates."""
    env = dict(os.environ if base is None else base)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(rank)
    return env


def _coordinator_bind_failed(results: List[subprocess.CompletedProcess]
                             ) -> bool:
    """Did this fleet die on the coordinator-port bind race?"""
    for r in results:
        if r.returncode == 0:
            continue
        text = (r.stderr or "").lower()
        if any(m in text for m in _BIND_FAILURE_MARKERS):
            return True
    return False


def _spawn_once(num_processes: int, argv: Sequence[str], coordinator: str,
                base_env: Optional[Dict[str, str]], timeout: float
                ) -> List[subprocess.CompletedProcess]:
    procs = [subprocess.Popen(
        [sys.executable, *argv],
        env=rank_env(rank, num_processes, coordinator, base=base_env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(num_processes)]
    deadline = time.monotonic() + timeout
    results: List[subprocess.CompletedProcess] = []
    for proc in procs:
        left = max(deadline - time.monotonic(), 0.1)
        try:
            out, err = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            out, err = proc.communicate()
        results.append(subprocess.CompletedProcess(
            proc.args, proc.returncode, out, err))
    return results


def spawn_emulated(num_processes: int, argv: Sequence[str], *,
                   base_env: Optional[Dict[str, str]] = None,
                   timeout: float = 600.0, bind_attempts: int = 3
                   ) -> List[subprocess.CompletedProcess]:
    """Launch ``python <argv...>`` num_processes times on localhost with a
    shared free-port coordinator; wait for all (killing every rank at the
    deadline); return per-rank results in rank order.  Does not raise on
    nonzero exits (``check_spawned`` does).  A fleet that failed to bind
    its coordinator port is relaunched with a fresh one, up to
    ``bind_attempts`` times with jittered backoff."""
    results: List[subprocess.CompletedProcess] = []
    delays = Backoff(attempts=max(1, bind_attempts) - 1, base=0.1).delays()
    for _ in range(max(1, bind_attempts)):
        coordinator = f"{HOST}:{free_port()}"
        results = _spawn_once(num_processes, argv, coordinator, base_env,
                              timeout)
        if not _coordinator_bind_failed(results):
            break
        try:
            time.sleep(next(delays))
        except StopIteration:  # attempts exhausted: return the last fleet
            break
    return results


def check_spawned(results: List[subprocess.CompletedProcess]) -> None:
    """Raise with the first failing rank's output attached."""
    for rank, r in enumerate(results):
        if r.returncode != 0:
            raise RuntimeError(
                f"emulated rank {rank} exited {r.returncode}\n"
                f"--- stdout ---\n{r.stdout}\n--- stderr ---\n{r.stderr}")


__all__ = ["DistributedConfig", "env_config", "initialize", "shutdown",
           "process_rank", "process_count", "free_port", "rank_env",
           "spawn_emulated", "check_spawned", "ENV_COORDINATOR",
           "ENV_NUM_PROCESSES", "ENV_PROCESS_ID"]
