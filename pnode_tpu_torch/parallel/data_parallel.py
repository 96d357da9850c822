"""Batch-axis data parallelism over ``torch.distributed`` ranks.

Counterpart of ``pnode_tpu/parallel/data_parallel.py``. The reference's
distribution story is PETSc/MPI held deliberately rank-local: each rank
integrates its own batch on COMM_SELF and nothing is communicated inside
the solve. Here:

- every rank is one process of an initialized process group (``torchrun``,
  or ``run_ranks``), and ``make_mesh`` lays the ranks out as a
  ``DeviceMesh`` with named axes (JAX's ``Mesh``);
- ``shard_batch`` keeps this rank's contiguous rows of the global batch,
  in JAX's device order;
- the whole forward solve and discrete adjoint run locally per rank;
- ``dp_value_and_grad`` means the loss and the gradients over the mesh
  axes with one ``all_reduce`` of a flat bucket (SUM, then a division by
  the number of ranks: gloo has no AVG), the only traffic of a step.

Explicit collectives, not ``DistributedDataParallel``: the reference's
semantics are exactly one mean per step, and the fused path
(``fused_dp.py``) has no autograd graph for DDP to hook.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..misc import tree_leaves, tree_map


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              mesh_shape: Optional[Sequence[int]] = None):
    """``DeviceMesh`` over the initialized process group; by default every
    rank on one "dp" axis. Multi-axis meshes (SURVEY.md section 5.8: ICI
    within a slice, DCN across hosts) take ``mesh_shape`` with matching
    ``axis_names``, e.g. ``make_mesh(mesh_shape=(2, 4), axis_names=("dcn",
    "dp"))``: rank r sits at (r // 4, r % 4). A mesh spans every rank of
    the group. Its device type follows the backend: "cuda" for NCCL, "cpu"
    for gloo (whose collectives take CUDA tensors too)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torchrun, or run_ranks)")
    world = dist.get_world_size()
    axis_names = tuple(axis_names)
    if mesh_shape is not None:
        mesh_shape = tuple(int(s) for s in mesh_shape)
        if len(mesh_shape) != len(axis_names):
            raise ValueError(
                f"mesh_shape {mesh_shape} must match axis_names {axis_names}")
        need = math.prod(mesh_shape)
        if world < need:
            raise ValueError(f"mesh_shape {mesh_shape} needs {need} devices "
                             f"but only {world} available")
    else:
        if len(axis_names) > 1:
            raise ValueError(
                "multi-axis meshes need mesh_shape=(...) matching axis_names")
        need = world if n_devices is None else int(n_devices)
        if world < need:
            raise ValueError(
                f"requested {need} devices but only {world} available (start "
                "more ranks: torchrun --nproc_per_node, or run_ranks)")
        mesh_shape = (need,)
    if need != world:
        raise ValueError(f"a mesh of {need} ranks must span the process "
                         f"group's {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape,
                            mesh_dim_names=axis_names)


def _axes(axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def shard_index(mesh, axis="dp"):
    """(this rank's shard, number of shards) when the batch is sharded over
    ``axis`` (a mesh-axis name, or a tuple of names whose product shards
    it, the first outermost): JAX's device order for that sharding."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in _axes(axis):
        dim = names.index(a)
        index = index * mesh.shape[dim] + coord[dim]
        count *= mesh.shape[dim]
    return index, count


def shard_batch(x, mesh, axis="dp"):
    """This rank's contiguous rows of tensor(s) ``x`` (a tensor, or tuples,
    lists and dicts of them) along dim 0, sharded over ``axis``."""
    index, count = shard_index(mesh, axis)

    def _shard(a):
        if a.shape[0] % count:
            raise ValueError(f"batch {a.shape[0]} must divide over {count} "
                             f"devices on mesh axis {axis!r}")
        rows = a.shape[0] // count
        return a[index * rows:(index + 1) * rows]

    return tree_map(_shard, x)


def replicate(x, mesh):
    """Rank 0's tensor(s) ``x`` on every rank (parameters, optimizer
    state): new tensors, broadcast from rank 0 of the mesh's group."""
    del mesh  # a mesh spans the whole group

    def _rep(a):
        out = a.detach().clone().contiguous()
        dist.broadcast(out, src=0)
        return out

    return tree_map(_rep, x)


def all_reduce_mean(flat, mesh, axis="dp"):
    """In place: ``flat`` becomes its mean over the ranks of ``axis`` (one
    ``all_reduce`` over the whole group when the axes cover the mesh, else
    one per axis)."""
    axes = _axes(axis)
    if set(axes) == set(mesh.mesh_dim_names):
        dist.all_reduce(flat)
        count = dist.get_world_size()
    else:
        count = 1
        for a in axes:
            dist.all_reduce(flat, group=mesh.get_group(a))
            count *= mesh.shape[list(mesh.mesh_dim_names).index(a)]
    if count > 1:
        flat /= count
    return flat


def dp_value_and_grad(loss_fn: Callable, mesh, axis="dp"):
    """Data-parallel value_and_grad: ``loss_fn(params, local_batch)`` is the
    scalar mean over the local batch. Returns ``fn(params, local_batch) ->
    (loss, grads)``: the global batch means, with ``grads`` in the structure
    of ``params`` (tensors that require grad, or the live parameters the
    loss reads). The solve runs locally; one all-reduce of the bucket
    [loss, grads...] means them over ``axis`` (a name or a tuple of names,
    hierarchical DP over their product)."""

    def fn(params, batch):
        leaves = tree_leaves(params)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        flat = torch.cat([loss.detach().reshape(1)]
                         + [g.reshape(-1) for g in grads])
        all_reduce_mean(flat, mesh, axis)
        out, off = [], 1
        for leaf in leaves:
            out.append(flat[off:off + leaf.numel()].view_as(leaf))
            off += leaf.numel()
        it = iter(out)
        return flat[0], tree_map(lambda _: next(it), params)

    return fn


# -- launcher ---------------------------------------------------------------

def _rank_main(rank, world_size, init_method, backend, device, timeout, fn,
               args, results):
    """One spawned rank: join the group, run fn(device, *args), report."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout))
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(world_size: int, fn: Callable, *args, backend: str = "gloo",
              device="cpu", timeout: float = 300.0):
    """Run ``fn(device, *args)`` on ``world_size`` fresh ranks and return
    their results, ordered by rank: the counterpart of the reference's
    virtual CPU mesh (``tests/conftest.py:17-21``). The ranks are spawned
    processes that join one group through a fresh ``file://`` store in a
    temporary directory (no TCP port), with ``timeout`` seconds on the
    group's collectives. ``fn`` and ``args`` are pickled: a module-level
    function, and numpy or CPU inputs. A rank that raises, dies or outlives
    the deadline (``timeout`` from the start) fails the call: every child
    is killed and RuntimeError (TimeoutError on expiry) is raised."""
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init, backend, str(device),
                                   timeout, fn, args, results))
                 for r in range(world_size)]
        got = {}
        try:
            for p in procs:
                p.start()
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world_size)) - set(got))
                    raise TimeoutError(f"run_ranks: ranks {missing} gave no "
                                       f"result within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank(s) {dead} exited "
                                           "without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
    return [got[r] for r in range(world_size)]
