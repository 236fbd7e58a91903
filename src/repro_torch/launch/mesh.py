"""Device meshes (the JAX package's ``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group: one process a device, started by
``torchrun --nproc-per-node N`` (or any spawner that sets up the group).
Every rank runs the host stages identically from the same seed, the SPMD
counterpart of JAX's single controller, and the mesh's named dims say
what is split over which ranks.

Mesh shapes (the reference's production meshes):
  single pod:  (data=16, model=16)
  multi-pod:   (pod=2, data=16, model=16)

Axis roles:
  'pod'    outermost data parallelism; the axis the int8 error-feedback
           all-reduce (``distributed.compression.ef_psum``) targets
  'data'   data parallel + FSDP parameter sharding (``fsdp_params``)
  'model'  tensor / expert parallel: heads, d_ff, experts, vocab
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

from repro_torch.kernels import runtime


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A mesh of ``shape`` named ``axes`` over the default process group
    (initialised by the caller).  ``device_type=None`` is CUDA, each rank
    on its own card (``runtime.resolve_device``), and raises without one;
    ``"cpu"`` builds a mesh of CPU ranks (the tests' gloo groups)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with torchrun or init_process_group first")
    dev = runtime.resolve_device(device_type)
    if dev.type == "cuda":
        # the rank's card, set before the mesh would set one itself (it
        # takes LOCAL_RANK as the card's ordinal: with several ranks on one
        # card that ordinal does not exist)
        import torch
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The reference's production mesh: (16, 16) ``("data", "model")`` or
    (2, 16, 16) ``("pod", "data", "model")``.  Raises unless the world
    size is exactly 256 or 512 (no stand-in devices are forced)."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = mesh_size_of(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the world has {world}")
    return make_mesh(shape, axes, device_type)


def mesh_size_of(shape: Iterable[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def mesh_size(mesh, axes: Optional[Iterable[str]] = None) -> int:
    """Ranks over the product of ``axes`` (a name or names) of ``mesh``;
    every dim when ``axes`` is None."""
    names = tuple(mesh.mesh_dim_names or ())
    if axes is None:
        axes = names
    elif isinstance(axes, str):
        axes = (axes,)
    return mesh_size_of(mesh.shape[names.index(a)] for a in axes)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor sharded over a mesh)."""
    import torch.distributed as dist
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch shards over."""
    return tuple(a for a in (mesh.mesh_dim_names or ()) if a in ("pod", "data"))


def n_batch_shards(mesh) -> int:
    return mesh_size(mesh, batch_axes(mesh))


def block_index(mesh, axes: Iterable[str]) -> int:
    """This rank's block of a leading axis split over ``axes`` (row-major
    over those dims, the reference's ``P(axes)`` order)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.mesh_dim_names or ())
    coord = mesh.get_coordinate()
    idx = 0
    for a in axes:
        i = names.index(a)
        idx = idx * mesh.shape[i] + coord[i]
    return idx


def writes(mesh) -> bool:
    """Whether this process writes the files of a run: every process
    without a mesh; in a meshed job, global rank 0 only."""
    if mesh is None:
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def barrier(mesh) -> None:
    """In a meshed job, wait for every rank (the mesh spans the default
    group); a no-op without a mesh."""
    if mesh is not None:
        import torch.distributed as dist
        dist.barrier()
