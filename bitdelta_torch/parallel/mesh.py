"""Device mesh construction (port of ``bitdelta_tpu/parallel/mesh.py``).

JAX drives every device from one controller over a named ``(data,
model)`` mesh. PyTorch's idiom is SPMD: one process per rank, each
holding only its shard of the weights and the cache, with explicit
collectives (:mod:`.collectives`) where JAX's ``shard_map`` puts
``psum``. :func:`make_mesh` therefore returns a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, its two dimensions named as JAX names its axes:
``"data"`` for batch rows, ``"model"`` for tensor parallelism.

The process group comes from :func:`initialize_multihost` (arguments, or
the environment ``torchrun`` sets); a process that builds a mesh without
one gets a world of one (over gloo, since it runs no collective). The backend is NCCL when every rank of the host
has a card of its own and gloo otherwise: on the CPU, and for several
ranks sharing one card (NCCL refuses two ranks on one device), where
gloo carries CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _backend(device_type: str, local_world: int) -> str:
    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _set_card(local_rank: int) -> None:
    """Put this rank on card ``local_rank % device_count`` before any
    DeviceMesh is made (DeviceMesh picks a card itself only when CUDA is
    not yet initialised, from ``LOCAL_RANK`` alone)."""
    resolve_device("cuda")
    torch.cuda.set_device(local_rank % torch.cuda.device_count())
    torch.cuda.init()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda", timeout=None) -> None:
    """Start this process's rank (``jax.distributed.initialize``'s place).

    With ``coordinator_address`` (an ``init_method`` URL such as
    ``"tcp://localhost:29500"`` or ``"file:///tmp/store"``) the world
    size and rank are the arguments; without it they come from the
    environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``). ``device``: ``"cuda"``
    (each rank takes card ``LOCAL_RANK % device_count``) or ``"cpu"``.
    ``timeout``: a ``datetime.timedelta`` for every collective (torch's
    default otherwise). Call once per process."""
    device_type = torch.device(device).type
    if coordinator_address is not None:
        world, rank = int(num_processes), int(process_id)
        init = dict(init_method=coordinator_address, world_size=world,
                    rank=rank)
    else:
        world, rank = (int(os.environ["WORLD_SIZE"]),
                       int(os.environ["RANK"]))
        init = dict(init_method="env://")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda":
        _set_card(int(os.environ.get("LOCAL_RANK", rank)))
    if timeout is not None:
        init["timeout"] = timeout
    dist.init_process_group(_backend(device_type, local_world), **init)


def make_mesh(shape: Optional[Tuple[int, int]] = None, *,
              device="cuda") -> "dist.device_mesh.DeviceMesh":
    """Build a ``(data, model)`` mesh over the first ``dp * tp`` ranks.

    Default: every rank on the model axis (TP), the right default for
    serving one sharded base model; pass ``shape=(dp, tp)`` to split.
    Without a process group (no :func:`initialize_multihost` and no
    ``torchrun`` environment) the process is a world of one."""
    from torch.distributed.device_mesh import DeviceMesh

    device_type = torch.device(device).type
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        initialize_multihost(device=device)
    if device_type == "cuda":
        # The current card stays this rank's: DeviceMesh picks one itself
        # only while CUDA is uninitialised.
        resolve_device("cuda")
        torch.cuda.init()
    if not dist.is_initialized():
        # A world of one runs no collective: gloo, so no NCCL
        # communicator is set up (or left to tear down at exit).
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    needed = shape[0] * shape[1]
    if needed > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {needed} devices, "
                         f"have {n}")
    ranks = torch.arange(needed, dtype=torch.int).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh(device="cuda"):
    return make_mesh((1, 1), device=device)
