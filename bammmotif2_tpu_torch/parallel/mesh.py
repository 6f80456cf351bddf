"""The ('data', 'seed') layout of ranks, and the collectives over it.

Port of ``bammmotif2_tpu.parallel.mesh``.  The sequence set shards over the
data axis: each rank holds a contiguous block of rows, and the one
collective of an EM iteration or a CGS sweep is a sum of the count tensor
(with the likelihood) over the ranks of the data axis.  A second axis
splits the seeds of a group: the ranks of one seed index refine their
slice of seeds, and ``all_gather_seeds`` hands every rank all of them at
the end.  The models are small and every rank keeps its own copy.

Rank r sits at (r // n_seed, r % n_seed), as the reference places its
devices (``devices.reshape(n_data, n_seed)``).  Every rank creates every
group, in one fixed order, as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on an (n_data, n_seed) layout of the world.

    ``data_group``: the ranks of this seed index (the count sums run over
    them); ``seed_group``: the ranks of this data index (seed results are
    gathered over them).
    """

    n_data: int
    n_seed: int
    data_index: int
    seed_index: int
    data_group: object = None
    seed_group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "seed": self.n_seed}


def make_mesh(n_data: int | None = None, n_seed: int = 1) -> Mesh:
    """The mesh of this rank over the initialized process group; n_data
    defaults to the world size over n_seed.  A (1, 1) mesh is legal: its
    collectives run over one rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize()")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_seed
    if n_data * n_seed != world:
        raise ValueError(f"mesh {n_data}x{n_seed} != {world} ranks")
    data_groups = [dist.new_group([d * n_seed + s for d in range(n_data)]) for s in range(n_seed)]
    seed_groups = [dist.new_group([d * n_seed + s for s in range(n_seed)]) for d in range(n_data)]
    d, s = divmod(rank, n_seed)
    return Mesh(n_data, n_seed, d, s, data_groups[s], seed_groups[d])


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int, fill) -> torch.Tensor:
    """``x`` with ``axis`` padded by ``fill`` to a multiple of ``multiple``."""
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def shard_em_data(mesh: Mesh, data: dict, sentinel: int) -> dict:
    """This rank's block of a ``refinement.em.prepare_data`` dict.

    N pads to a multiple of n_data with rows of length 0 whose codes are all
    ``sentinel`` (they contribute log(1-q) to ll and nothing to the counts;
    ``n_real`` corrects for them), and the rank keeps its contiguous block
    of ``cidx`` and ``lens``; ``bg_flat`` stays whole.  The block carries
    where it lies: ``row0`` (its first row), ``n_global`` (the rows before
    padding) and ``n_padded`` (after).
    """
    cidx, lens = data["cidx"], data["lens"]
    n_global = int(lens.shape[0])
    cidx = pad_to_multiple(cidx, mesh.n_data, 1, sentinel)
    lens = pad_to_multiple(lens, mesh.n_data, 0, 0)
    n_padded = int(lens.shape[0])
    n_local = n_padded // mesh.n_data
    row0 = mesh.data_index * n_local
    return {
        "cidx": cidx[:, row0 : row0 + n_local].contiguous(),
        "lens": lens[row0 : row0 + n_local].contiguous(),
        "bg_flat": data["bg_flat"],
        "row0": row0,
        "n_global": n_global,
        "n_padded": n_padded,
    }


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on ``t`` goes through host memory: CUDA tensors
    on a gloo group (gloo's CUDA support differs between torch builds and
    collectives; its host path takes every one of them)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (the data group), on ``t``'s device;
    it may be ``t`` itself, summed in place.  Every rank gets the same sum.
    On a gloo group a CUDA tensor is staged through host memory."""
    if _host_staged(t, group):
        h = t.cpu().contiguous()
        dist.all_reduce(h, group=group)
        return h.to(t.device)
    t = t.contiguous()
    dist.all_reduce(t, group=group)
    return t


def all_gather_seeds(mesh: Mesh, *tensors: torch.Tensor) -> list:
    """Each tensor's slices of the seed groups, concatenated along its
    leading (seed) axis in seed-index order, on every rank.  Every rank's
    slice has the same shape.  On a gloo group CUDA tensors are staged
    through host memory."""
    out = []
    for t in tensors:
        src = (t.cpu() if _host_staged(t, mesh.seed_group) else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.n_seed)]
        dist.all_gather(parts, src, group=mesh.seed_group)
        out.append(torch.cat(parts).to(t.device))
    return out
