"""Multi-process bring-up: torch.distributed from a launcher's environment,
and the mesh shape.

Port of ``bammmotif2_tpu.parallel.distributed``.  Every rank runs the same
command (``torchrun --nproc-per-node N -m bammmotif2_tpu_torch.cli ...``),
loads the whole FASTA, and ``initialize`` joins the process group that
torchrun's variables describe (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``).  ``auto_mesh`` then lays the ranks out as
the reference lays out its devices (``parallel.mesh``).

The environment alone decides whether to join, as in the reference: a
launch without those variables (and without ``force``) is one process and
nothing is touched.  A launch with them that cannot join raises; it never
goes on as one process.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket

import torch
import torch.distributed as dist

from bammmotif2_tpu_torch.parallel import mesh as mesh_mod
from bammmotif2_tpu_torch.utils import device as device_mod

# how long a rank waits for the others at bring-up
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def launched() -> bool:
    """Whether a launcher's environment is set (WORLD_SIZE and RANK)."""
    return bool(os.environ.get("WORLD_SIZE") and os.environ.get("RANK"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(force: bool = False, backend: str | None = None, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group of a multi-process launch.

    Returns True when a process group is up (also a one-rank group), False
    for a single-process launch, which touches nothing.  With ``force`` and
    no launcher's environment it brings up a one-rank group on localhost.

    ``device``: the run's device (None: CUDA, as ``utils.device.resolve``).
    On CUDA each rank binds ``cuda:LOCAL_RANK`` and the backend is NCCL; on
    the CPU it is gloo.  ``backend`` overrides that choice (gloo for two
    ranks on one card, which NCCL refuses).  Raises if the environment is
    set and the group cannot be joined within ``timeout``.
    """
    if dist.is_initialized():
        return True
    if not (force or launched()):
        return False
    if launched():
        rendezvous = dict(init_method="env://")
    else:
        rendezvous = dict(init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    dev = device_mod.resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    try:
        dist.init_process_group(backend=backend, timeout=timeout, **rendezvous)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"torch.distributed bring-up failed (backend {backend}, rank "
            f"{os.environ.get('RANK')} of {os.environ.get('WORLD_SIZE')}, MASTER_ADDR "
            f"{os.environ.get('MASTER_ADDR')}:{os.environ.get('MASTER_PORT')}): {e}"
        ) from e
    atexit.register(shutdown)
    return True


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_main() -> bool:
    """Whether this process writes files and prints: rank 0, or a single
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_shape(world: int, n_seeds: int) -> tuple:
    """(n_data, n_seed) for ``world`` ranks and ``n_seeds`` seeds: the seed
    axis is the largest divisor of the world size that is at most the seed
    count (extra ranks do more data-parallel work instead), the data axis
    the rest."""
    n_seed = next(c for c in range(min(max(n_seeds, 1), world), 0, -1) if world % c == 0)
    return world // n_seed, n_seed


def auto_mesh(n_seeds: int = 1):
    """The mesh over all ranks (``mesh_shape``); None for one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return mesh_mod.make_mesh(*mesh_shape(dist.get_world_size(), n_seeds))
