"""Multi-process bootstrap — counterpart of
``hpmn_tpu/parallel/distributed.py`` on ``torch.distributed``.

One process per rank. :func:`initialize` joins the ranks into one process
group; :func:`rank_device` is the card a rank drives. Under ``python -m
torch.distributed.run`` the environment names everything
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``); otherwise the caller passes the
coordinator's address, the number of processes and this process's id, as
to ``jax.distributed.initialize``.

A host is the ranks of one machine (``LOCAL_WORLD_SIZE`` of them, all of
them when the variable is unset). The training loader shards the data by
host, as the JAX loader shards it by process, and the ranks of a host
split their host's batch as the JAX mesh splits it over that host's
devices (``mesh.shard_batch``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# The collectives wait this long for a slow rank before raising.
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def default_backend(device="cuda") -> str:
    """``nccl`` for ranks on the card, ``gloo`` for ranks on the CPU."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> None:
    """Idempotent ``init_process_group``. A no-op when the group exists,
    and for a true single-process run (one process and no coordinator,
    neither passed nor set by ``torch.distributed.run``).

    ``coordinator_address``: ``host:port``, ``tcp://host:port`` or
    ``file:///path`` (a rendezvous file no rank has used yet); default
    ``MASTER_ADDR:MASTER_PORT``. ``num_processes`` and ``process_id``
    default to ``WORLD_SIZE`` and ``RANK``. ``backend=None`` is
    :func:`default_backend` of ``device``; an explicit ``backend`` (for
    example ``"gloo"`` for several ranks on one card) is taken as given.
    """
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        if world is not None and world > 1:
            raise ValueError(f"{world} processes need a coordinator_address "
                             "(or MASTER_ADDR/MASTER_PORT)")
        return
    if world is None or rank is None:
        raise ValueError("a coordinator_address needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend or default_backend(device),
                            init_method=coordinator_address,
                            world_size=world, rank=rank, timeout=TIMEOUT)


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and side files."""
    return process_index() == 0


def local_world_size() -> int:
    """The ranks of this host: ``LOCAL_WORLD_SIZE``, else every rank."""
    return _env_int("LOCAL_WORLD_SIZE") or process_count()


def local_rank() -> int:
    """This rank's index among its host's: ``LOCAL_RANK``, else the rank
    modulo :func:`local_world_size`."""
    lr = _env_int("LOCAL_RANK")
    return lr if lr is not None else process_index() % local_world_size()


def host_index() -> int:
    """This rank's host: ranks are numbered host by host."""
    return process_index() // local_world_size()


def host_count() -> int:
    return max(1, process_count() // local_world_size())


def rank_device(device="cuda") -> torch.device:
    """The device this rank drives: the CPU when ``device`` is the CPU,
    else ``cuda:LOCAL_RANK`` modulo the card count (several ranks share a
    card when there are more ranks than cards; NCCL refuses that, gloo
    takes it). An explicit ``cuda:N`` is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device('cuda') needs a card; pass "
                           "device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())
