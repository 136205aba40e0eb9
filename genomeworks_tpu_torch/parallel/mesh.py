"""The data-parallel "mesh" of the port: one process per device in a
``torch.distributed`` process group.

Counterpart of genomeworks_tpu/parallel/mesh.py. The reference scales
across GPUs with one CPU worker thread per device pulling from a shared
queue (cudamapper/src/main.cu:453-594); the JAX package runs one program
over a ``jax.sharding.Mesh``. On CUDA the PyTorch idiom is one process per
card: each rank computes on its own device and holds its own contiguous
slice of a batch, and results meet through collectives (NCCL on the
cards, gloo where the group was made with it, over host tensors).

``batch_sharding`` (a NamedSharding over the leading dim) has no PyTorch
counterpart, since no tensor spans ranks: :func:`shard_range` took its
place, the rows of a batch this rank holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from genomeworks_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group.

    ``group`` is the process group, or None for one rank without one;
    ``device`` the device this rank computes on; ``comm_device`` the device
    the collectives move tensors on: the card under NCCL, the CPU under
    gloo (or with no group)."""

    group: object | None
    rank: int
    size: int
    device: torch.device
    comm_device: torch.device
    axis_name: str = DATA_AXIS


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS, device=None,
              group=None) -> Mesh:
    """This rank's mesh: over ``group`` (default: the initialised default
    group; with none, one rank). ``device`` is where this rank computes
    (``None`` = the CUDA card of this process, which raises without one;
    the CPU when named). ``n_devices``, when given, must equal the group's
    size: each rank is one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, size, comm = 0, 1, torch.device("cpu")
    else:
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        backend = dist.get_backend(group)
        if backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("an NCCL group needs ranks that compute on CUDA")
            comm = dev
        else:
            comm = torch.device("cpu")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the group has {size} ranks "
                         "(one process per device)")
    return Mesh(group, rank, size, dev, comm, axis_name)


def pad_batch_to_multiple(arrays: list[np.ndarray], multiple: int) -> list[np.ndarray]:
    """Pad the leading dim of each array to a multiple (so it shards evenly).
    Padding rows are zeros; callers mask by length vectors as usual."""
    out = []
    for a in arrays:
        b = a.shape[0]
        pad = (-b) % multiple
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)], axis=0)
        out.append(a)
    return out


def shard_range(mesh: Mesh, batch: int) -> tuple[int, int]:
    """[lo, hi): the contiguous rows of a batch of ``batch`` rows that this
    rank holds (``batch`` a multiple of ``mesh.size``, as after
    :func:`pad_batch_to_multiple`)."""
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} does not split over {mesh.size} ranks")
    per = batch // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def batch_sharding(mesh: Mesh, batch: int) -> tuple[int, int]:
    """No PyTorch counterpart of the JAX NamedSharding: no tensor spans
    ranks. Returns :func:`shard_range` (mesh, batch), which took its place."""
    return shard_range(mesh, batch)


def shard_batch(mesh: Mesh, *arrays, axis_name: str = DATA_AXIS):
    """This rank's contiguous leading-dim slice of each array (NumPy or
    tensor, the same leading dim, a multiple of the mesh size), as tensors
    on ``mesh.device``."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    if not arrays:
        return ()
    lo, hi = shard_range(mesh, len(arrays[0]))
    out = []
    for a in arrays:
        if len(a) != len(arrays[0]):
            raise ValueError("arrays to shard must share their leading dim")
        out.append(torch.as_tensor(a[lo:hi]).to(mesh.device).contiguous())
    return tuple(out)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes on every rank) concatenated along
    dim 0 in rank order, on ``mesh.device``; ``x`` itself with no group."""
    if mesh.group is None:
        return x
    xs = x.to(mesh.comm_device).contiguous()
    parts = [torch.empty_like(xs) for _ in range(mesh.size)]
    dist.all_gather(parts, xs, group=mesh.group)
    return torch.cat(parts).to(mesh.device)


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on ``mesh.device``; ``x`` itself
    with no group."""
    if mesh.group is None:
        return x
    xs = x.to(mesh.comm_device).clone()
    dist.all_reduce(xs, op=dist.ReduceOp.SUM, group=mesh.group)
    return xs.to(mesh.device)


def gather_ragged_rows(mesh: Mesh, rows: torch.Tensor) -> list[torch.Tensor]:
    """Each rank's ``rows`` (n_r, C) int64, n_r differing by rank, as a list
    in rank order on every rank, on the CPU: the counts are gathered first,
    then the rows padded to the largest count (a gather needs equal
    shapes)."""
    rows = rows.to(torch.int64)
    if mesh.group is None:
        return [rows.cpu()]
    count = torch.tensor([rows.shape[0]], dtype=torch.int64)
    counts = all_gather_rows(mesh, count.to(mesh.device)).cpu().tolist()
    cap = max(counts)
    padded = torch.full((cap, rows.shape[1]), -1, dtype=torch.int64, device=rows.device)
    padded[: rows.shape[0]] = rows
    gathered = all_gather_rows(mesh, padded).cpu().reshape(mesh.size, cap, rows.shape[1])
    return [gathered[r, : counts[r]] for r in range(mesh.size)]
