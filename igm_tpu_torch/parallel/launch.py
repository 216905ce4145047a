"""Starting the data axis's ranks: counterpart of ``igm_tpu/train.py:22-25``
(``IGM_MULTIHOST=1``: ``jax.distributed.initialize()``) and of the one
process that drives every local device under GSPMD.

``trainer.devices=N`` (N > 1; -1: every visible card) runs N ranks, one
process each, spawned by :func:`spawn` (``torch.multiprocessing``, the
``spawn`` start method) and joined over a free loopback port: on the card
NCCL, one card a rank (``cuda:rank``); with ``--device cpu``, or with more
ranks than cards (ranks then share the cards, rank r on card r mod count),
gloo.  A rank that fails ends the launch: ``spawn`` stops the others and
raises, and every collective has a finite timeout (``TIMEOUT_S``), so no
rank waits for ever on a peer that died.

``IGM_MULTIHOST=1`` joins a group that ``torchrun`` launched instead
(:func:`init_from_env`), on one host or several: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the environment,
one process per card (``cuda:LOCAL_RANK``).  torchrun numbers the ranks
node by node, the order :func:`spawn` gives them on one host, so each rank
takes the rows it would take there (``tools/multihost_dryrun.py`` runs two
nodes on one host).
"""
from __future__ import annotations

import datetime
import gc
import os
import socket
import time
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective, or the group's set-up, waits for the other ranks
TIMEOUT_S = 600


def free_port() -> int:
    """A TCP port free on the loopback interface now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return int(sock.getsockname()[1])


def world_size(devices: int, device: torch.device) -> int:
    """The ranks ``trainer.devices`` asks for: N, or with -1 every visible
    card (one process on the CPU)."""
    devices = -1 if devices is None else int(devices)
    if devices == -1:
        return torch.cuda.device_count() if device.type == "cuda" else 1
    if devices < 1:
        raise ValueError(f"trainer.devices must be -1 or at least 1, got {devices}")
    return devices


def init_rank(rank: int, world: int, address: str, device: torch.device) -> torch.device:
    """Join the group of ``world`` ranks at ``address`` (``tcp://host:port``)
    as ``rank``; returns the device the rank computes on."""
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        device = torch.device("cuda", rank % cards)
        torch.cuda.set_device(device)
        backend = "nccl" if world <= cards else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def init_from_env(device: torch.device) -> torch.device:
    """``IGM_MULTIHOST=1``: join the group ``torchrun`` started, from its
    environment; one card a process (``cuda:LOCAL_RANK``)."""
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if device.type == "cuda":
        local, cards = int(env["LOCAL_RANK"]), torch.cuda.device_count()
        if local >= cards:
            raise ValueError(
                f"LOCAL_RANK={local}, but this process sees {cards} card(s) "
                f"(CUDA_VISIBLE_DEVICES={env.get('CUDA_VISIBLE_DEVICES', '<unset>')}): a node "
                f"runs at most one process a visible card (torchrun --nproc-per-node); nodes "
                f"that share a host each need their own cards in CUDA_VISIBLE_DEVICES")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=address,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def leave_group() -> None:
    """Leave the process group (and the mesh's subgroups: the model, fsdp
    and batch groups) once a rank's work is done.  A CUDA graph that
    captured an NCCL collective, on any of them, keeps the communicator's
    destruction waiting while the graph lives, and the port's graphs sit
    in reference cycles with their models: collect them first.  (A rank that raises
    does not come here: it exits, and its launch ends the others.)"""
    gc.collect()
    dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable[..., Any], world: int, address: str,
               device: torch.device, args: Sequence[Any]) -> None:
    device = init_rank(rank, world, address, device)
    fn(device, *args)
    leave_group()


def spawn(fn: Callable[..., Any], world: int, device: torch.device,
          args: Sequence[Any] = (), timeout: Optional[float] = None) -> None:
    """``fn(rank_device, *args)`` in ``world`` spawned processes joined into
    one group over a free loopback port; returns when all have finished.
    ``fn`` is pickled by its import path (a module-level function).  A rank
    that raises or dies stops the others, and this raises; so does a launch
    still running after ``timeout`` seconds, its ranks killed."""
    address = f"tcp://127.0.0.1:{free_port()}"
    context = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, address, device, tuple(args)), nprocs=world,
        join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not context.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
        if deadline is not None and time.monotonic() >= deadline:
            for process in context.processes:
                process.kill()
            for process in context.processes:
                process.join()
            raise TimeoutError(f"{world} ranks still running after {timeout} s: killed")
