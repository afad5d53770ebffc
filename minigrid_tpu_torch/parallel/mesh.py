"""Data parallelism over devices: one process per device on ``torch.distributed``.

Counterpart of ``minigrid_tpu/parallel/mesh.py``.  The JAX package runs one
SPMD program over a ``jax.sharding.Mesh``: XLA's partitioner shards the env
batch over the mesh's ``data`` axis and inserts the collectives itself.
Here every device has a process of its own in a ``torch.distributed``
group.  A rank holds a contiguous shard of the env batch and a replica of
the parameters, and the learners reduce over the ranks explicitly
(``rl/ppo.py``, ``rl/impala.py``): the gradients once a minibatch, a few
statistics and the metrics.  Nothing of trajectory size crosses ranks.

Every collective the port issues goes through ``all_reduce`` or
``broadcast`` below, which log its payload in ``COLLECTIVES``
(``parallel/scaling.expected_collectives`` says what a train step should
log).  Those two are the collectives gloo also takes on CUDA tensors,
staged through the host, which is how two ranks can share one card: NCCL
refuses two ranks on one device.

Random streams: a rank draws from ``rank_generator(generator, rank)``, where
the JAX package folds the device index into the key.  A sharded run equals
the mesh-less run of each shard from its rank generator, not the unsharded
run.

``python -m minigrid_tpu_torch.parallel.mesh`` runs ``dryrun_multichip`` over
every visible GPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from minigrid_tpu_torch.core.state import tree_map
from minigrid_tpu_torch.parallel.reset_budget import check_pool
from minigrid_tpu_torch.parallel.vector import fused_eligible, plain_pool_size, rollout_random

# How long a rank waits for its peers (rendezvous and every collective)
# before it fails instead of hanging.
DEFAULT_TIMEOUT = timedelta(seconds=300)

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D data-parallel group: the process
    group, this rank, the number of ranks and the rank's device.
    ``axis_name`` is kept for the JAX package's signatures."""

    group: Any
    rank: int
    world_size: int
    device: torch.device
    axis_name: str = "data"


@dataclasses.dataclass
class CollectiveLog:
    """(op, payload bytes) of every collective this process issued, in
    order; ``op`` is ``"all_reduce(sum)"``, ``"all_reduce(max)"``,
    ``"all_reduce(min)"`` or ``"broadcast"``.  With ``timed`` set, each
    collective also synchronises its device before and after, and its
    milliseconds on the host's clock go to ``ms``, one per entry: the wait
    for the slowest rank included."""

    entries: list[tuple[str, int]] = dataclasses.field(default_factory=list)
    timed: bool = False
    ms: list[float] = dataclasses.field(default_factory=list)

    def clear(self) -> None:
        self.entries.clear()
        self.ms.clear()


COLLECTIVES = CollectiveLog()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def synchronize(mesh: Mesh) -> None:
    """Wait for the work queued on the mesh's device (nothing on the CPU)."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


@contextlib.contextmanager
def _logged(mesh: Mesh, op: str, tensor: torch.Tensor):
    COLLECTIVES.entries.append((op, _nbytes(tensor)))
    if not COLLECTIVES.timed:
        yield
        return
    synchronize(mesh)
    t0 = time.perf_counter()
    yield
    synchronize(mesh)
    COLLECTIVES.ms.append((time.perf_counter() - t0) * 1e3)


def all_reduce(mesh: Mesh, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """``tensor`` reduced over the ranks with ``op`` (sum, max or min), in
    place; returns it."""
    with _logged(mesh, f"all_reduce({op})", tensor):
        dist.all_reduce(tensor, _REDUCE_OPS[op], group=mesh.group)
    return tensor


def broadcast(mesh: Mesh, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place; returns it."""
    with _logged(mesh, "broadcast", tensor):
        dist.broadcast(tensor, src, group=mesh.group)
    return tensor


def all_reduce_mean(mesh: Mesh, tensors) -> list[torch.Tensor]:
    """The mean over the ranks of each of ``tensors`` (one dtype), through
    ONE all-reduce of a flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce(mesh, flat).div_(mesh.world_size)
    out, start = [], 0
    for t in tensors:
        out.append(flat[start : start + t.numel()].view_as(t))
        start += t.numel()
    return out


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> None:
    """Join the process group: the arguments where given, else torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``; with
    neither, a group of this one process (an in-memory store).  Does
    nothing where a group exists.  ``timeout`` bounds the rendezvous and,
    on gloo, every collective, so a dead peer fails the others."""
    if dist.is_initialized():
        return
    rank, world_size = _env_int("RANK", rank), _env_int("WORLD_SIZE", world_size)
    world_size = 1 if world_size is None else world_size
    if rank is None:
        if world_size != 1:
            raise ValueError(f"a group of {world_size} ranks needs this process's rank (RANK or rank=)")
        rank = 0
    kwargs = dict(backend=backend, rank=rank, world_size=world_size, timeout=timeout)
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError(
                f"a group of {world_size} ranks needs a rendezvous: init_method= (tcp:// or file://) or "
                "MASTER_ADDR and MASTER_PORT"
            )
        dist.init_process_group(store=dist.HashStore(), **kwargs)
    else:
        dist.init_process_group(init_method=init_method, **kwargs)


def make_mesh(
    device=None,
    backend: str | None = None,
    *,
    init_method: str | None = None,
    rank: int | None = None,
    world_size: int | None = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """This process's ``Mesh``, joining the group (``init_distributed``)
    where it has not been joined.

    The device is ``cuda:{LOCAL_RANK}`` unless the caller names one (tests
    pass ``"cpu"``); no GPU is no fallback to the CPU but an error.  The
    backend is NCCL for a CUDA device and gloo for the CPU unless the caller
    names one; NCCL takes one device per rank, so more ranks on this host
    than devices, or a device other than ``cuda:{LOCAL_RANK}``, is a
    ``ValueError`` (gloo can share a device)."""
    world = _env_int("WORLD_SIZE", world_size) or 1
    global_rank = _env_int("RANK", rank) or 0
    local_rank = _env_int("LOCAL_RANK", None)
    local_rank = global_rank if local_rank is None else local_rank
    device = torch.device(f"cuda:{local_rank}" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        local_world = _env_int("LOCAL_WORLD_SIZE", None) or world
        count = torch.cuda.device_count()
        if local_world > count:
            raise ValueError(
                f"NCCL takes one device per rank: {local_world} ranks on this host and {count} CUDA devices, so two "
                "ranks would share one; use backend='gloo' to share a device"
            )
        if local_world > 1 and device != torch.device("cuda", local_rank):
            raise ValueError(f"NCCL takes one device per rank: local rank {local_rank} asked for {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for {device}; pass device='cpu' to run on the CPU")
        if device.index >= torch.cuda.device_count():
            raise ValueError(f"{device} does not exist: {torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(device)
    init_distributed(backend, init_method, rank, world_size, timeout)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), device)


def local_count(mesh: Mesh, num_envs: int) -> int:
    """This rank's share of ``num_envs``; ``ValueError`` where the ranks
    cannot take equal shares."""
    if num_envs % mesh.world_size != 0:
        raise ValueError(f"num_envs={num_envs} is not divisible by the {mesh.world_size} ranks of the mesh")
    return num_envs // mesh.world_size


def _map(fn, tree):
    """``core/state.tree_map``, through named tuples (a ``Trajectory``) and
    dicts of them too."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree_map(fn, tree)


def shard_batch(mesh: Mesh, tree, axis: int = 0):
    """This rank's contiguous slice ``[r*n/W, (r+1)*n/W)`` of every leaf of
    ``tree`` along ``axis`` (the env axis: 0 for states, 1 for a time-major
    trajectory), on the mesh's device."""

    def local(x):
        n = local_count(mesh, x.shape[axis])
        return x.narrow(axis, mesh.rank * n, n).to(mesh.device)

    return _map(local, tree)


def replicate(mesh: Mesh, tree):
    """Rank 0's tensors on every rank: the leaves of ``tree`` (or a
    module's parameters and buffers), moved to the mesh's device, packed
    into one buffer a dtype and broadcast; updated in place and returned."""
    if isinstance(tree, torch.nn.Module):
        tree.to(mesh.device)
        leaves = [t.data for t in (*tree.parameters(), *tree.buffers())]
    else:
        tree = _map(lambda x: x.to(mesh.device), tree)
        leaves = []
        _map(leaves.append, tree)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = broadcast(mesh, torch.cat([t.reshape(-1) for t in group]))
        start = 0
        for t in group:
            t.copy_(flat[start : start + t.numel()].view_as(t))
            start += t.numel()
    return tree


def rank_generator(generator: torch.Generator, rank: int, device=None) -> torch.Generator:
    """The generator of rank ``rank``: a ``torch.Generator`` on ``device``
    (the generator's own where None) seeded from ``(a draw of generator,
    rank)``, as ``compat/gym`` seeds an episode's generator; the JAX
    package's ``fold_in(key, axis_index)``.  The draw advances
    ``generator`` as ``env.reset`` and ``rollout_random`` advance theirs, so
    a reset and the rollouts after it each get streams of their own; every
    rank holds the same generator, so every rank draws the same value."""
    draw = int(torch.randint(2**62, (1,), generator=generator, device=generator.device))
    seed = int(np.random.SeedSequence([draw, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=generator.device if device is None else device).manual_seed(seed)


def sharded_reset(env, mesh: Mesh, generator: torch.Generator, num_envs: int):
    """``env.reset`` of this rank's ``num_envs / W`` envs on the mesh's
    device, drawn from the rank's generator; returns (obs, states)."""
    n = local_count(mesh, num_envs)
    return env.reset(n, rank_generator(generator, mesh.rank, mesh.device), mesh.device)


def sharded_rollout_fused(
    env,
    mesh: Mesh,
    states,
    generator: torch.Generator,
    num_steps: int,
    resets_per_chunk: int | None = None,
):
    """``parallel/vector.rollout_random`` of this rank's shard ``states``
    from the rank's generator: through the rollout kernel where
    ``fused_eligible`` says it runs, one launch a rank.  The JAX package's
    ``sharded_rollout`` too: both have these per-rank streams here.

    Returns (states, total_reward, episodes, max_used): the local final
    states, the reward and episode totals summed over the ranks and
    ``max_used`` maximised over them, one all-reduce each.  The plain path
    of an ``expensive_reset`` family draws each rank's own shared pool,
    sized from the local env count; its capacity check runs after the
    reduction, so the ranks raise together.  ``max_used`` is held to
    ``rollout_capacity`` of the local shard."""
    fused = fused_eligible(env, states.device)
    gen = rank_generator(generator, mesh.rank, mesh.device)
    final, total_r, total_done, max_used = rollout_random(
        env, states, gen, num_steps, resets_per_chunk, fused, check=False
    )
    total_r = all_reduce(mesh, torch.as_tensor(total_r, device=mesh.device).clone())
    total_done = all_reduce(mesh, torch.as_tensor(total_done, device=mesh.device).clone())
    max_used = all_reduce(mesh, torch.as_tensor(max_used, device=mesh.device).clone(), "max")
    if not fused and env.expensive_reset:
        check_pool(int(max_used), plain_pool_size(env, num_steps, states.step_count.shape[0], resets_per_chunk))
    return final, total_r, total_done, max_used


def dryrun_multichip(n_devices: int, device: str | None = None) -> list[dict]:
    """One PPO and one IMPALA train step on ``MiniGrid-Empty-8x8-v0``
    (``rollout_steps=4``, ``num_minibatches=2``, hidden 64) in each of
    ``n_devices`` spawned ranks, with finite losses asserted; returns the
    ranks' metrics.  ``device=None`` puts rank r on ``cuda:r``, ``"cpu"``
    every rank on the CPU (gloo); ``make_mesh`` picks the backend."""
    from minigrid_tpu_torch.parallel.mp_worker import run_workers

    spec = {"learners": dict(env_id="MiniGrid-Empty-8x8-v0", num_envs=64 * n_devices, rollout_steps=4,
                             num_minibatches=2, hidden=64, ppo_steps=1, impala_steps=1, seed=0)}
    outs = [r["learners"] for r in run_workers(spec, n_devices, device=device).results]
    for rank, out in enumerate(outs):
        for learner in ("ppo", "impala"):
            losses = [out[learner][0]["metrics"][k] for k in ("pg_loss", "value_loss", "entropy")]
            if not all(np.isfinite(losses)):
                raise AssertionError(f"rank {rank}: {learner} losses {losses}")
    return outs


if __name__ == "__main__":
    count = torch.cuda.device_count()
    if count == 0:
        sys.exit("no CUDA device: dryrun_multichip runs one rank a GPU (dryrun_multichip(n, device='cpu') on the CPU)")
    for r, out in enumerate(dryrun_multichip(count)):
        print(f"rank {r}: PPO {out['ppo'][0]['metrics']}; IMPALA {out['impala'][0]['metrics']}")
