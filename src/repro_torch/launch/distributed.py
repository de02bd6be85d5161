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
through the host, so gloo is also the backend of a fleet with one rank a
card.  Each spawned rank sees one card, as a launcher that gives a task
one GPU arranges it (``CUDA_VISIBLE_DEVICES``, ``rank_card``): rank r
the r-th card the launcher sees, round robin, so ranks share a card only
on a host with fewer cards than ranks, and ``"cuda"`` names a rank's own
card.  Spawned ranks get the runtime preset (``launch/runtime_env.py``:
tcmalloc where the host has it, torch's C++ logs kept to errors) unless
the caller turns it off.  ``global_mesh`` gives a 1-D ``DeviceMesh`` over
every rank; a process that is not part of a fleet joins a one-rank group
for it.  Importing this module starts nothing.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.faults.retry import Backoff
from repro_torch.launch.runtime_env import runtime_env

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_VISIBLE_CARDS = "CUDA_VISIBLE_DEVICES"
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
    """Leave the fleet, or the one-rank group ``join_alone`` made
    (idempotent)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def join_alone() -> None:
    """Make this process a one-rank group over an in-memory store (no
    port, no peer) unless a group is up: a mesh needs a group, and
    ``initialize`` starts none for one process."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(),
                                world_size=1, rank=0)


def global_mesh(axis: str = "data", device_type: str = "cuda"):
    """1-D ``DeviceMesh`` named `axis` over every rank of the default
    group, in rank order (rank r holds shard r of an evenly split axis,
    the contiguous-ownership layout the per-host writer tier relies
    on)."""
    from torch.distributed.device_mesh import init_device_mesh

    join_alone()
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


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
             base: Optional[Dict[str, str]] = None,
             preset: bool = True) -> Dict[str, str]:
    """Child environment for emulated rank `rank`: the fleet coordinates
    plus, with `preset`, the runtime preset (tcmalloc, log level)."""
    env = (runtime_env(base) if preset
           else dict(os.environ if base is None else base))
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(rank)
    return env


def rank_card(rank: int, environ: Optional[Dict[str, str]] = None
              ) -> Optional[str]:
    """The one card emulated rank `rank` sees: round robin over the cards
    of the launcher's ``CUDA_VISIBLE_DEVICES`` (in `environ`, default the
    process's), else over every card of the host; None without a card."""
    env = os.environ if environ is None else environ
    visible = env.get(ENV_VISIBLE_CARDS)
    if visible is None:
        cards = [str(i) for i in range(torch.cuda.device_count())]
    else:
        cards = [c.strip() for c in visible.split(",") if c.strip()]
    return cards[rank % len(cards)] if cards else None


def _spawn_env(rank: int, num_processes: int, coordinator: str,
               base_env: Optional[Dict[str, str]], preset: bool
               ) -> Dict[str, str]:
    """``rank_env`` with the rank's one card (``rank_card``)."""
    env = rank_env(rank, num_processes, coordinator, base=base_env,
                   preset=preset)
    card = rank_card(rank, base_env)
    if card is not None:
        env[ENV_VISIBLE_CARDS] = card
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
                base_env: Optional[Dict[str, str]], preset: bool,
                timeout: float) -> List[subprocess.CompletedProcess]:
    procs = [subprocess.Popen(
        [sys.executable, *argv],
        env=_spawn_env(rank, num_processes, coordinator, base_env, preset),
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
                   preset: bool = True, timeout: float = 600.0,
                   bind_attempts: int = 3
                   ) -> List[subprocess.CompletedProcess]:
    """Launch ``python <argv...>`` num_processes times on localhost with a
    shared free-port coordinator; wait for all (killing every rank at the
    deadline); return per-rank results in rank order.  Does not raise on
    nonzero exits (``check_spawned`` does).  A fleet that failed to bind
    its coordinator port is relaunched with a fresh one, up to
    ``bind_attempts`` times with jittered backoff.  `preset` applies the
    runtime preset to every rank's environment (``rank_env``); each rank
    sees one card (``rank_card``)."""
    results: List[subprocess.CompletedProcess] = []
    delays = Backoff(attempts=max(1, bind_attempts) - 1, base=0.1).delays()
    for _ in range(max(1, bind_attempts)):
        coordinator = f"{HOST}:{free_port()}"
        results = _spawn_once(num_processes, argv, coordinator, base_env,
                              preset, timeout)
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
           "join_alone", "global_mesh", "process_rank", "process_count",
           "free_port", "rank_env", "rank_card", "spawn_emulated",
           "check_spawned", "ENV_COORDINATOR", "ENV_NUM_PROCESSES",
           "ENV_PROCESS_ID", "ENV_VISIBLE_CARDS"]
