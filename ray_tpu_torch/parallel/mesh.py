"""Device mesh: the port of ray_tpu/parallel/mesh.py over ``torch.distributed``.

Every parallel strategy is a named dimension of one ``DeviceMesh`` over the
ranks of the default process group, in the reference's order (leading dims
get the slower links):

  data   - pure data parallel (gradients summed over the dim)
  pipe   - pipeline parallel (the GPipe step, ``parallel.pipeline``)
  fsdp   - data parallel with parameters and optimizer state sharded (ZeRO-3)
  tensor - megatron-style tensor parallel
  seq    - sequence parallel (ring attention over the dim's ranks)
  expert - MoE expert parallel

Where the JAX module builds a ``jax.sharding.Mesh`` over the devices of one
controller, a torch mesh spans one process per device, each holding its
shards, so the differences are:

- ``make_mesh`` is ``init_device_mesh`` over ``AXES``. ``device_type=None``
  means ``"cuda"`` over NCCL and raises without a card; ``"cpu"`` means gloo.
  Nothing falls back, and there is no ``devices`` argument: the mesh covers
  every rank of the process group (``n``, when given, must be its size).
  Each rank's device is ``cuda:LOCAL_RANK`` (``rank_device``).
- ``initialize_distributed`` is ``init_process_group`` from the rank
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) with a
  ``FileStore`` when a store path is given (``RAY_TPU_TORCH_STORE`` is what
  ``parallel.launch`` sets), an in-memory store for a world of one, and the
  ``MASTER_ADDR``/``MASTER_PORT`` convention otherwise.
- ``SliceInfo`` is a rank's place among nodes read from that environment (a
  node is what a TPU slice is to the reference: ranks on one host share its
  fast links); ``multislice_env`` gives the environment variables that place
  a node in a multi-node world; ``dcn_mesh`` leads with a ``dcn`` dim over
  nodes; ``ici_neighbors`` gives this rank's ring neighbours along a mesh dim
  as global ranks (the JAX function gives positions along the axis).

The parallel package uses public ``torch.distributed`` API only:
``init_device_mesh`` with ``mesh_dim_names`` and ``DeviceMesh.get_group``/
``get_local_rank`` (torch 2.2), and ``torch.distributed.tensor``'s
``DTensor``/``Shard``/``Replicate`` (public from torch 2.5), so it needs
torch 2.5 or later; it runs on 2.11 (the card) and 2.13 (the CPU tests).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist

AXES = ("data", "pipe", "fsdp", "tensor", "seq", "expert")
STORE_ENV = "RAY_TPU_TORCH_STORE"  # FileStore path set by parallel.launch


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism layout. -1 on `data` means 'absorb remaining devices'."""

    data: int = -1
    pipe: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dataclasses.asdict(self)
        fixed = math.prod(v for v in sizes.values() if v != -1)
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError("At most one mesh axis may be -1")
        if free:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"Mesh {sizes} needs {math.prod(sizes.values())} devices, have {n_devices}"
            )
        return sizes


def _device_type(device_type: str | None) -> str:
    """``None`` is the card, which must be there; ``"cpu"`` is asked for."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("ray_tpu_torch.parallel: no CUDA device is available; pass "
                               "device_type='cpu' to run the ranks over gloo")
        return "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return device_type


def rank_device(device_type: str | None = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` on the card, else the CPU."""
    if _device_type(device_type) == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def initialize_distributed(device_type: str | None = None, *, store_path: str | None = None,
                           rank: int | None = None, world_size: int | None = None) -> None:
    """``init_process_group`` from the rank environment: NCCL on the card
    (``device_type=None``, raises without one), gloo for ``"cpu"``. The
    rendezvous is a ``FileStore`` at ``store_path`` (or ``$RAY_TPU_TORCH_STORE``),
    an in-memory store for a world of one, else ``env://``. A no-op when
    the default group exists."""
    kind = _device_type(device_type)
    if dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None else world_size
    backend = "nccl" if kind == "cuda" else "gloo"
    if kind == "cuda":
        torch.cuda.set_device(rank_device(kind))
    store_path = store_path or os.environ.get(STORE_ENV)
    if store_path:
        store = dist.FileStore(store_path, world_size)
    elif world_size == 1:
        store = dist.HashStore()
    else:
        dist.init_process_group(backend, rank=rank, world_size=world_size)
        return
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def make_mesh(n_devices: int | None = None, *, data: int = -1, pipe: int = 1, fsdp: int = 1,
              tensor: int = 1, seq: int = 1, expert: int = 1, device_type: str | None = None):
    """A ``DeviceMesh`` over every rank, dims named ``AXES`` and sized by
    ``MeshSpec.resolve``. Initializes the default group from the rank
    environment when it is not yet."""
    kind = _device_type(device_type)
    initialize_distributed(kind)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks asked for in a world of {world}")
    sizes = MeshSpec(data=data, pipe=pipe, fsdp=fsdp, tensor=tensor, seq=seq,
                     expert=expert).resolve(world)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(kind, tuple(sizes[a] for a in AXES), mesh_dim_names=AXES)


def single_device_mesh(device_type: str | None = None):
    """A 1-rank mesh with all axes size 1 — lets sharded code run unmodified."""
    return make_mesh(1, data=1, device_type=device_type)


def mesh_shape(mesh) -> dict[str, int]:
    """``{dim name: size}``, as ``jax.sharding.Mesh.shape`` reads."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass
class SliceInfo:
    """A rank's place among nodes, from the launcher's environment
    (``GROUP_RANK``/``NODE_RANK``, ``LOCAL_WORLD_SIZE``, as torchrun sets
    them). The JAX class reads a TPU slice's name, type and topology."""

    node_name: str
    num_nodes: int
    node_id: int
    local_rank: int
    local_world_size: int

    @staticmethod
    def detect() -> "SliceInfo":
        env = os.environ
        world = int(env.get("WORLD_SIZE", "1"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
        return SliceInfo(
            node_name=os.uname().nodename,
            num_nodes=max(1, world // max(1, local_world)),
            node_id=int(env.get("GROUP_RANK", env.get("NODE_RANK", "0"))),
            local_rank=int(env.get("LOCAL_RANK", "0")),
            local_world_size=local_world,
        )


def multislice_env(coordinator_address: str, num_slices: int, slice_id: int) -> dict[str, str]:
    """The environment that places node ``slice_id`` of ``num_slices`` in
    one world: the rendezvous address (``host:port``) and the node's index.
    A fresh full set, never to be merged with a stale one."""
    host, _, port = coordinator_address.rpartition(":")
    return {
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
        "NNODES": str(num_slices),
        "NODE_RANK": str(slice_id),
        "GROUP_RANK": str(slice_id),
    }


def dcn_mesh(num_slices: int, ici_axes: "dict[str, int] | None" = None,
             device_type: str | None = None):
    """A mesh whose LEADING dim ``dcn`` spans nodes and whose other dims
    tile each node's ranks. Ranks are numbered node-major (as torchrun
    numbers them), so a contiguous reshape puts each node on one row, and
    gradients over ``dcn`` cross the slower links while the model dims stay
    inside a node."""
    kind = _device_type(device_type)
    initialize_distributed(kind)
    world = dist.get_world_size()
    if world % num_slices:
        raise ValueError(f"{world} devices not divisible by {num_slices} slices")
    per_slice = world // num_slices
    ici_axes = dict(ici_axes or {"data": per_slice})
    if math.prod(ici_axes.values()) != per_slice:
        raise ValueError(f"ici axes {ici_axes} != {per_slice} devices/slice")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(kind, (num_slices, *ici_axes.values()),
                            mesh_dim_names=("dcn", *ici_axes))


def axis_ranks(mesh, axis: str) -> list[int]:
    """Global ranks along ``axis`` through this rank, in the dim's order."""
    coord = list(mesh.get_coordinate())
    d = mesh.mesh_dim_names.index(axis)
    line = mesh.mesh[tuple(coord[:d]) + (slice(None),) + tuple(coord[d + 1:])]
    return [int(r) for r in line.tolist()]


def ici_neighbors(mesh, axis: str) -> tuple[int, int]:
    """(prev, next) global ranks of this rank's ring neighbours along ``axis``."""
    ranks = axis_ranks(mesh, axis)
    idx = mesh.get_local_rank(axis)
    return ranks[(idx - 1) % len(ranks)], ranks[(idx + 1) % len(ranks)]
