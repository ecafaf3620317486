"""Logical-axis sharding rules: the port of ray_tpu/parallel/sharding.py.

One rule table translates logical tensor axes ("embed", "mlp", "heads",
"seq", ...) to mesh dims, as in the reference. Where JAX reads the result as
a ``PartitionSpec`` (one entry per TENSOR dim, naming mesh axes), a DTensor
reads it as placements (one per MESH dim): ``Shard(d)`` on every mesh dim
that tensor dim ``d`` maps to, ``Replicate()`` on the others. A logical axis
that maps to a tuple of mesh dims, ``batch -> ("data", "fsdp")``, shards the
same tensor dim over both, the first named being the outer split, as JAX
splits it; the tuple must follow the mesh's dim order.

``shard_params`` cuts each rank's shard out of the full tensor that every
rank holds (no communication: the counterpart of ``jax.device_put`` of host
arrays) and wraps it with ``DTensor.from_local``; ``constrain`` is
``redistribute``. Shards are even: a sharded tensor dim must divide by the
product of its mesh dims' sizes.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu_torch.parallel.mesh import AXES, rank_device

# logical axis -> mesh axis (None = replicated). Megatron-style layout:
#   embed dim sharded over tensor for attn/mlp weights; batch over (data, fsdp);
#   params additionally sharded over fsdp (ZeRO-3) on their largest axis.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "embed": None,
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "vocab": "tensor",
    "expert": "expert",
    # parameter (ZeRO-3) sharding axes
    "embed_fsdp": "fsdp",
    "mlp_fsdp": "fsdp",
}


def spec_from_logical(logical_axes: Sequence[str | None], rules: Mapping[str, Any] | None = None,
                      mesh_dims: Sequence[str] = AXES) -> list:
    """Placements, one per mesh dim in ``mesh_dims``, for a tensor whose
    dims carry ``logical_axes``."""
    rules = rules or DEFAULT_RULES
    out = [Replicate() for _ in mesh_dims]
    for d, ax in enumerate(logical_axes):
        target = None if ax is None else rules.get(ax)
        if target is None:
            continue
        names = (target,) if isinstance(target, str) else tuple(target)
        idx = [mesh_dims.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"{ax!r} -> {names}: mesh dims must follow the mesh order")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh dim {mesh_dims[i]!r} shards two tensor dims")
            out[i] = Shard(d)
    return out


def named_sharding(mesh, logical_axes: Sequence[str | None], rules=None) -> list:
    """The placements of ``logical_axes`` on ``mesh``."""
    return spec_from_logical(logical_axes, rules, mesh.mesh_dim_names)


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements``: each ``Shard(d)``
    cuts dim ``d`` into equal pieces along its mesh dim, outer mesh dims
    first."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.mesh.shape[i]
            if out.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(full.shape)} does not divide over "
                                 f"{mesh.mesh_dim_names[i]!r} of size {n}")
            out = out.chunk(n, dim=p.dim)[coord[i]]
    return out


def distribute(full: torch.Tensor, mesh, placements) -> DTensor:
    """A DTensor of ``full`` (held whole by every rank) on ``mesh``'s device."""
    device = rank_device(mesh.device_type)
    local = local_chunk(full, mesh, placements).to(device).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.contiguous().stride())


def constrain(x, mesh, *logical_axes: str | None, rules=None) -> DTensor:
    """``x`` laid out as ``logical_axes`` says: ``redistribute`` of a DTensor,
    ``distribute`` of a full tensor."""
    placements = named_sharding(mesh, logical_axes, rules)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute(x, mesh, placements)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(mesh, logical_tree, rules=None):
    """Map a tree of logical-axis tuples to a tree of placements."""
    return _map(lambda axes: named_sharding(mesh, axes, rules), logical_tree)


def place_params(params, placements_tree, mesh):
    """Every full tensor of ``params`` as a DTensor on ``mesh`` placed as
    ``placements_tree`` says (host -> device, sharded)."""
    return _map(lambda p, s: distribute(p, mesh, s), params, placements_tree)


def shard_params(params, logical_tree, mesh, rules=None):
    """Every full tensor of ``params`` as a DTensor on ``mesh`` placed by its
    logical axes (host -> device, sharded)."""
    return place_params(params, tree_shardings(mesh, logical_tree, rules), mesh)


def replicated(mesh) -> list:
    return [Replicate() for _ in mesh.mesh_dim_names]


def batch_sharding(mesh) -> list:
    """[B, ...] batches: dim 0 over ``data`` then ``fsdp``."""
    return named_sharding(mesh, ("batch",))
