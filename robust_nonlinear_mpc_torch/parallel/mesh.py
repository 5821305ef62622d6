"""The scenario mesh over torch.distributed (port of
`robust_nonlinear_mpc_tpu/parallel/mesh.py`).

JAX lays a batch over a `jax.sharding.Mesh` and reduces with psum / pmax
inside `shard_map`. Here the mesh is a torch.distributed process group with
one process (rank) per device, the counterpart of `jax.distributed`'s
multi-controller form: every rank receives the same global inputs, takes its
own contiguous block of the batch axis (`shard_batch`: rank r of W holds
lanes [rB/W, (r+1)B/W), the block `NamedSharding` puts on device r), and the
collectives map as psum -> `all_reduce(.., "sum")`, pmax ->
`all_reduce(.., "max")`, and a sharded result back into the global layout
-> `all_gather`. The backend is NCCL on the card and gloo on the CPU; gloo
also runs two ranks on one card, which NCCL refuses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from robust_nonlinear_mpc_torch.utils.batch import tree_map

SCENARIO_AXIS = "scenarios"


class Mesh(NamedTuple):
    """A 1-D mesh: this process's place in a process group."""

    group: object          # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device   # where this rank computes


def scenario_mesh(n_devices: int | None = None, group=None, device=None) -> Mesh:
    """The 1-D mesh of the ranks of `group` (default: every rank). One
    process per device, so `n_devices`, if given, must be the group's size.
    `device` defaults to this rank's card under NCCL and to the CPU under
    gloo. Raises when torch.distributed is not initialized
    (`parallel.distributed.init_distributed`)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "parallel.distributed.init_distributed first")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"a mesh of {n_devices} devices needs a group of {n_devices} ranks "
                         f"(one process per device); this group has {size}")
    if device is None:
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"
    return Mesh(group, rank, size, torch.device(device))


def shard_batch(mesh: Mesh, tree):
    """This rank's contiguous block of the leading (batch) axis of every
    tensor of `tree`, on the mesh's device. The batch must divide evenly."""
    def block(t):
        t = torch.as_tensor(t)
        B = t.shape[0]
        if B % mesh.size:
            raise ValueError(f"a batch of {B} does not split over {mesh.size} ranks")
        n = B // mesh.size
        return t[mesh.rank * n : (mesh.rank + 1) * n].to(mesh.device)

    return tree_map(block, tree)


def _via_host(mesh: Mesh, t: torch.Tensor) -> bool:
    # gloo's CUDA collectives are not in every build: a CUDA tensor under
    # gloo (two ranks sharing one card) is staged through the host for the
    # collective alone; the computation stays on the card
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """psum ("sum") or pmax ("max") of `t` over the mesh, as a new tensor on
    `t`'s device."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    host = _via_host(mesh, t)
    buf = t.detach().to("cpu", copy=True) if host else t.detach().clone()
    dist.all_reduce(buf, op=red, group=mesh.group)
    return buf.to(t.device) if host else buf


def all_gather(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's block of `t` (equal shapes), concatenated along `dim` in
    rank order: the sharded result in the global layout."""
    src = t.detach()
    is_bool = src.dtype == torch.bool
    if is_bool:
        src = src.to(torch.uint8)
    host = _via_host(mesh, src)
    src = (src.cpu() if host else src).contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(outs, src, group=mesh.group)
    out = torch.cat(outs, dim=dim).to(t.device)
    return out.bool() if is_bool else out


def gather_tree(mesh: Mesh, tree, dim: int = 0):
    """`all_gather` over every tensor of a tree of NamedTuples / tuples."""
    return tree_map(lambda t: all_gather(mesh, t, dim), tree)


def sharded(mesh: Mesh, run):
    """run(*batches) -> tree, over the mesh: every rank calls the result with
    the same global batches, runs `run` on its own block of each
    (`shard_batch`) and gets the tree gathered into the global layout."""
    return lambda *batches: gather_tree(mesh, run(*shard_batch(mesh, batches)))
