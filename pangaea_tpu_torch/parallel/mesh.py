"""Process-group bring-up: the port's counterpart of pangaea_tpu's mesh.

pangaea_tpu is single-controller: one process drives a ('data',) mesh of
devices through ``shard_map``/GSPMD. PyTorch's idiom is one process per
device in a ``torch.distributed`` process group — NCCL for CUDA tensors,
gloo for CPU tensors — launched by ``torchrun --nproc-per-node N`` or by
``torch.multiprocessing`` with the ``spawn`` start method. Each rank
holds its own rows; what pangaea_tpu replicates, every rank holds a copy
of. So the group and each rank's device take the place of the mesh:
pangaea_tpu's ``data_sharding``/``replicated_sharding`` (``NamedSharding``
layouts of one array over many devices) have no counterpart, and the
port does not invent one.

A CUDA device on a group whose backend is not NCCL raises, and so does a
CPU device on an NCCL group (:func:`check_backend`): nothing moves a
tensor to the CPU to make a collective work.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from pangaea_tpu_torch.config import ParallelConfig
from pangaea_tpu_torch.utils import DeviceLike, resolve_device

log = logging.getLogger(__name__)

Group = Optional[dist.ProcessGroup]


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (torchrun's
    ``LOCAL_RANK``, else 0) unless the caller asks for another."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a ``file://`` path is made
    absolute (``file://build/x`` would name a host ``build``)."""
    if address.startswith("file://"):
        return "file://" + os.path.abspath(address[len("file://"):])
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(cfg: ParallelConfig, device: DeviceLike = None,
                           timeout_s: float = 600.0) -> Group:
    """Join the default process group and return it, or None.

    A no-op (returning the existing group) when one is already
    initialised, and (returning None) on a single process with
    ``use_distributed=False``. Otherwise the backend follows the device
    (NCCL for ``cuda``, gloo for ``cpu``; :func:`rank_device` picks
    it), the rendezvous is ``cfg.coordinator_address`` with
    ``num_processes`` ranks and rank ``process_id``, or, without an
    address, torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
    ``WORLD_SIZE``."""
    if dist.is_initialized():
        return dist.group.WORLD
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not cfg.use_distributed and cfg.num_processes == 1 and env_world == 1:
        return None
    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    if cfg.coordinator_address:
        dist.init_process_group(
            backend, init_method=_init_method(cfg.coordinator_address),
            world_size=cfg.num_processes, rank=cfg.process_id,
            timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    log.info("process group: rank %d of %d, %s on %s", dist.get_rank(),
             dist.get_world_size(), backend, dev)
    return dist.group.WORLD


def data_group(group: Group = None) -> dist.ProcessGroup:
    """The group the data is split over (the default group unless one
    is given): the port's ``data_mesh``. Raises when no group has been
    initialised (:func:`initialize_distributed`)."""
    if group is not None:
        return group
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.initialize_distributed first")
    return dist.group.WORLD


def world_size(group: Group = None) -> int:
    """Ranks in ``group`` (1 where no group is initialised)."""
    if group is None and not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def check_backend(group: dist.ProcessGroup, device: torch.device) -> None:
    """A CUDA device needs an NCCL group, a CPU device a non-NCCL
    (gloo) group; anything else raises."""
    backend = str(dist.get_backend(group)).lower()
    if device.type == "cuda" and backend != "nccl":
        raise ValueError(f"{device} tensors need an NCCL group, not "
                         f"{backend}")
    if device.type == "cpu" and backend == "nccl":
        raise ValueError("cpu tensors need a gloo group, not nccl")
