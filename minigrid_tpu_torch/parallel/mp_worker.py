"""Worker processes for the data-parallel paths: ``run_workers`` spawns one
process a rank, each joins a ``torch.distributed`` group through a file
store in a fresh temporary directory, runs the modes of a spec in order and
saves what they return.

Counterpart of ``tools/mp_worker.py``.  A child imports only ``torch`` and
this package, never a test module.  Every wait is bounded: the group's
timeout bounds each rendezvous and collective, and the parent kills what
still runs at its own deadline.  Usage (``run_workers`` builds the spec):

    python -m minigrid_tpu_torch.parallel.mp_worker DIR RANK WORLD_SIZE BACKEND DEVICE

Modes (``spec = {mode or "mode:label": arguments, ...}``):
    basics   replicate a tensor, a tree and a network from rank 0; sum, max, min
    rollout  sharded_reset, then sharded_rollout_fused, held to the mesh-less
             rollout_random of the shard from the rank generator
    resets   LearnerResets.observe where only rank 0's chunk nears R
    update   the mesh update of PPO or IMPALA on the given trajectory's shard
    learners PPO and IMPALA train steps: metrics, launches, collectives (and
             with time_allreduce each one's time inside the step), the
             ranks' parameters and Adam state compared, times
    meshless PPO train steps on a one-rank mesh and of the mesh-less learner,
             in turns whose order alternates, then the next collection and
             update held to the mesh-less ones
    raise    one rank raises while the others wait in a collective
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# Seconds a rank waits for its peers (rendezvous and each collective).
GROUP_TIMEOUT = 60.0


@dataclasses.dataclass
class WorkerRun:
    """The ranks' exit codes (None: killed at the deadline), what each saved
    (None where it saved nothing), the tail of each one's output, and the
    seconds from start to the last exit."""

    rcs: list
    results: list
    logs: list[str]
    seconds: float


class WorkerError(RuntimeError):
    pass


def run_workers(
    spec: dict,
    world_size: int,
    backend: str | None = None,
    device: str | None = None,
    timeout: float = 300.0,
    group_timeout: float = GROUP_TIMEOUT,
    check: bool = True,
) -> WorkerRun:
    """Run the modes of ``spec`` in ``world_size`` spawned ranks
    (``device`` None: rank r on ``cuda:r``; a device string: every rank on
    it) and wait at most ``timeout`` seconds, then kill what still runs.
    With ``check``, raise ``WorkerError`` unless every rank exited 0."""
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        torch.save({"modes": spec, "group_timeout": group_timeout}, Path(tmp) / "spec.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        t0 = time.monotonic()
        procs = []
        for rank in range(world_size):
            log = open(Path(tmp) / f"rank{rank}.log", "w")
            cmd = [sys.executable, "-m", "minigrid_tpu_torch.parallel.mp_worker", tmp, str(rank),
                   str(world_size), backend or "default", device or "default"]
            procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env={**env, "LOCAL_RANK": str(rank)}, cwd=ROOT))
            log.close()
        deadline = t0 + timeout
        for p in procs:
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        rcs = []
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rcs.append(None)
            else:
                rcs.append(p.returncode)
        seconds = time.monotonic() - t0
        logs = [(Path(tmp) / f"rank{r}.log").read_text()[-4000:] for r in range(world_size)]
        results = [
            torch.load(path, weights_only=False, map_location="cpu") if path.exists() else None
            for path in (Path(tmp) / f"out{r}.pt" for r in range(world_size))
        ]
    run = WorkerRun(rcs, results, logs, seconds)
    if check and any(rc != 0 for rc in rcs):
        raise WorkerError(f"ranks exited {rcs} after {seconds:.1f} s:\n" + "\n".join(
            f"--- rank {r} ---\n{log}" for r, log in enumerate(logs)
        ))
    return run


def _launches() -> dict[str, int]:
    from minigrid_tpu_torch.ops import actor_rollout as ar
    from minigrid_tpu_torch.ops import embed_dense as ed
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import obs_packed as op

    return {"K1": fr.KERNEL_LAUNCHES, "K2": ar.KERNEL_LAUNCHES, "K4": op.KERNEL_LAUNCHES,
            "K3 fwd": ed.KERNEL_LAUNCHES["fwd"], "K3 bwd": ed.KERNEL_LAUNCHES["bwd"]}


def _zero_launches() -> None:
    from minigrid_tpu_torch.ops import actor_rollout as ar
    from minigrid_tpu_torch.ops import embed_dense as ed
    from minigrid_tpu_torch.ops import fused_rollout as fr
    from minigrid_tpu_torch.ops import obs_packed as op

    fr.KERNEL_LAUNCHES = ar.KERNEL_LAUNCHES = op.KERNEL_LAUNCHES = 0
    ed.KERNEL_LAUNCHES.update(fwd=0, bwd=0)


def _cpu(tree):
    from minigrid_tpu_torch.parallel.mesh import _map

    return _map(lambda x: x.detach().cpu(), tree)


def same_on_every_rank(mesh, tensors) -> bool:
    """Whether every rank holds these tensors bit for bit: a position-
    weighted checksum of their bits, its maximum and minimum over the ranks
    (two all-reduces) equal."""
    total = torch.zeros((), dtype=torch.int64, device=mesh.device)
    for t in tensors:
        bits = t.detach().reshape(-1)
        bits = bits.view(torch.int32) if bits.dtype == torch.float32 else bits
        weight = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        total = total + (bits.to(torch.int64) * weight).sum()
    from minigrid_tpu_torch.parallel.mesh import all_reduce

    hi, lo = all_reduce(mesh, total.clone(), "max"), all_reduce(mesh, total.clone(), "min")
    return bool(hi == lo)


def _basics(mesh, a):
    from minigrid_tpu_torch.parallel.mesh import COLLECTIVES, all_reduce, replicate
    from minigrid_tpu_torch.rl.model import ActorCritic

    COLLECTIVES.clear()
    x = replicate(mesh, torch.arange(4.0) + 10 * mesh.rank)
    tree = replicate(mesh, {"f": torch.full((3,), float(mesh.rank)), "i": torch.full((2, 2), mesh.rank)})
    gen = torch.Generator(device=mesh.device).manual_seed(100 + mesh.rank)
    model = replicate(mesh, ActorCritic(8, 3, 3, gen, mesh.device))
    value = torch.tensor(float(mesh.rank + 1), device=mesh.device)
    reductions = {op: float(all_reduce(mesh, value.clone(), op)) for op in ("sum", "max", "min")}
    return {"x": _cpu(x), "tree": _cpu(tree), "model": _cpu(model.state_dict()), "reductions": reductions,
            "log": list(COLLECTIVES.entries)}


def _rollout(mesh, a):
    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.core.state import tree_leaves
    from minigrid_tpu_torch.parallel import mesh as mesh_lib
    from minigrid_tpu_torch.parallel.vector import rollout_capacity, rollout_random

    kwargs = {"max_steps": a["max_steps"]} if "max_steps" in a else {}
    env = mgt.make(a["env_id"], **kwargs)
    _, states = mesh_lib.sharded_reset(env, mesh, torch.Generator(device=mesh.device).manual_seed(a["reset_seed"]),
                                       a["num_envs"])
    gen = torch.Generator(device=mesh.device).manual_seed(a["seed"])
    steps, resets = a["steps"], a.get("resets_per_chunk")
    mesh_lib.synchronize(mesh)
    _zero_launches()
    t0 = time.perf_counter()
    final, total_r, episodes, max_used = mesh_lib.sharded_rollout_fused(env, mesh, states, gen, steps, resets)
    mesh_lib.synchronize(mesh)
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    rank_gen = mesh_lib.rank_generator(torch.Generator(device=mesh.device).manual_seed(a["seed"]), mesh.rank)
    alone = rollout_random(env, states, rank_gen, steps, resets)
    equal = all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(final), tree_leaves(alone[0])))
    n = states.step_count.shape[0]
    out = {
        "total_reward": float(total_r), "episodes": int(episodes), "max_used": int(max_used),
        "local": (float(alone[1]), int(alone[2]), int(alone[3])), "equal": equal, "launches": launches,
        "capacity": rollout_capacity(env, steps, mesh.device, num_envs=n, resets_per_chunk=resets),
        "ms": ms, "num_envs": n,
    }
    if a.get("return_states"):
        out["final"] = _cpu(final)
    return out


def _resets(mesh, a):
    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.rl.rollout import LearnerResets

    resets = LearnerResets(mgt.make(a["env_id"]), a["rollout_steps"])
    r0 = resets.r
    done = torch.zeros((max(r0, a["rollout_steps"]), 4), dtype=torch.bool, device=mesh.device)
    if mesh.rank == 0:
        done[:r0, 1] = True  # env 1 of rank 0 ends r0 episodes: R's margin
    metrics = resets.observe(done, mesh)
    return {"r0": r0, "r": resets.r, "metrics": {k: int(v) for k, v in metrics.items()}}


def _learner(a, mesh):
    import minigrid_tpu_torch as mgt
    from minigrid_tpu_torch.rl.impala import IMPALAConfig, make_impala
    from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

    env = mgt.make(a["env_id"])
    if a.get("learner", "ppo") == "ppo":
        config = PPOConfig(**a["config"]) if "config" in a else PPOConfig(
            rollout_steps=a["rollout_steps"], num_minibatches=a["num_minibatches"])
        return env, config, make_ppo(env, config, hidden=a["hidden"], mesh=mesh)
    config = IMPALAConfig(**a["config"]) if "config" in a else IMPALAConfig(
        rollout_steps=a["rollout_steps"], num_minibatches=a["num_minibatches"])
    return env, config, make_impala(env, config, hidden=a["hidden"], mesh=mesh)


def _update(mesh, a):
    from minigrid_tpu_torch.parallel.mesh import COLLECTIVES, shard_batch
    from minigrid_tpu_torch.rl.model import ActorCritic
    from minigrid_tpu_torch.rl.ppo import adam_init

    env, _, (_, step) = _learner(a, mesh)
    model = ActorCritic(a["hidden"], env.num_actions, env.agent_view_size, device=mesh.device)
    model.load_state_dict(a["params"])
    states = shard_batch(mesh, a["env_states"])
    traj = shard_batch(mesh, a["traj"], axis=1)
    COLLECTIVES.clear()
    model, opt_state, metrics = step.update(model, adam_init(model), states, traj)
    return {"params": _cpu(model.state_dict()), "mu": _cpu(opt_state.mu), "nu": _cpu(opt_state.nu),
            "count": opt_state.count, "metrics": _cpu(metrics), "log": list(COLLECTIVES.entries)}


def _train_steps(mesh, step, state, count: int, sabotage: bool = False, timed: bool = False):
    """``count`` train steps, each as its two phases, timed apart; per step
    the metrics, the launches and collectives of that step alone (with
    ``timed``, each collective's milliseconds inside the step, from
    ``COLLECTIVES.ms``), whether every rank then holds the same parameters
    and Adam state, and the trajectory's leaves' bytes.  ``sabotage`` also
    all-reduces the last step's observations: the negative control the log
    must flag."""
    from minigrid_tpu_torch.parallel.mesh import COLLECTIVES, all_reduce, synchronize
    from minigrid_tpu_torch.rl.ppo import TrainState

    steps = []
    for i in range(count):
        synchronize(mesh)
        _zero_launches()
        COLLECTIVES.clear()
        COLLECTIVES.timed = timed
        try:
            t0 = time.perf_counter()
            final, traj = step.rollout(state.params, state.env_states, state.generator)
            synchronize(mesh)
            t1 = time.perf_counter()
            if sabotage and i == count - 1:
                all_reduce(mesh, traj.obs.clone())
            model, opt_state, metrics = step.update(state.params, state.opt_state, final, traj)
            synchronize(mesh)
            t2 = time.perf_counter()
        finally:
            COLLECTIVES.timed = False
        state = TrainState(model, opt_state, final, state.generator)
        log, collective_ms, launches = list(COLLECTIVES.entries), list(COLLECTIVES.ms), _launches()
        same = same_on_every_rank(mesh, [*model.state_dict().values(), *opt_state.mu.values(), *opt_state.nu.values()])
        steps.append({
            "metrics": {k: float(v) for k, v in metrics.items()}, "launches": launches, "log": log,
            "same": same, "count": opt_state.count, "rollout_ms": (t1 - t0) * 1e3, "update_ms": (t2 - t1) * 1e3,
            "collective_ms": collective_ms,
            "traj_bytes": {k: v.numel() * v.element_size() for k, v in traj._asdict().items()},
        })
    return state, steps


def _learners(mesh, a):
    from minigrid_tpu_torch.parallel.scaling import expected_collectives

    out = {}
    for learner in ("ppo", "impala"):
        count = a.get(f"{learner}_steps", 0)
        if not count:
            continue
        _, config, (init_fn, step) = _learner({**a, "learner": learner}, mesh)
        state = init_fn(torch.Generator(device=mesh.device).manual_seed(a["seed"]), a["num_envs"])
        out[f"{learner}_expected"] = expected_collectives(state.params, config, learner)
        _, out[learner] = _train_steps(mesh, step, state, count, a.get("sabotage", False) and learner == "ppo",
                                       a.get("time_allreduce", False))
    return out


def _largest_difference(a: dict, b: dict) -> float:
    """The largest absolute difference between two dicts of tensors."""
    return max((float((a[k].double() - b[k].double()).abs().max()) for k in a), default=0.0)


def _meshless(mesh, a):
    import copy

    from minigrid_tpu_torch.core.state import tree_leaves
    from minigrid_tpu_torch.rl.ppo import AdamState, make_ppo
    from minigrid_tpu_torch.rl.rollout import collect_trajectory

    env, config, (init_fn, step) = _learner(a, mesh)
    init_plain, step_plain = make_ppo(env, config, hidden=a["hidden"])
    # The mesh learner's steps and the mesh-less learner's, timed the same
    # way in this process, in turns: mesh first, then mesh-less first, and
    # so on, so that neither always runs second.
    runs = {
        "ppo": [step, init_fn(torch.Generator(device=mesh.device).manual_seed(a["seed"]), a["num_envs"])],
        "meshless_ppo": [step_plain, init_plain(torch.Generator(device=mesh.device).manual_seed(a["seed"]), a["num_envs"])],
    }
    out = {name: [] for name in runs}
    for i in range(a["ppo_steps"]):
        for name in list(runs)[:: 1 if i % 2 == 0 else -1]:
            learner_step, learner_state = runs[name]
            runs[name][1], taken = _train_steps(mesh, learner_step, learner_state, 1)
            out[name] += taken
    state = runs["ppo"][1]
    # The next collection, on the mesh and without one, from one generator
    # state; then both updates of the mesh's trajectory.
    model = copy.deepcopy(state.params)
    opt_state = AdamState(state.opt_state.count, *({k: v.clone() for k, v in d.items()} for d in state.opt_state[1:]))
    gen = torch.Generator(device=mesh.device)
    gen.set_state(state.generator.get_state())
    final, traj = step.rollout(state.params, state.env_states, state.generator)
    plain_final, plain_traj = collect_trajectory(
        env, model, state.env_states, gen, config.rollout_steps, step.resets.r, fused_actor=True
    )
    out["collection_equal"] = all(
        torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves((final, tuple(traj))), tree_leaves((plain_final, tuple(plain_traj))))
    )
    _, plain = make_ppo(env, config, hidden=a["hidden"])
    plain.resets.r = step.resets.r
    m_mesh, o_mesh, met_mesh = step.update(state.params, state.opt_state, final, traj)
    m_plain, o_plain, met_plain = plain.update(model, opt_state, final, traj)
    pairs = {
        "params": (m_mesh.state_dict(), m_plain.state_dict()), "mu": (o_mesh.mu, o_plain.mu),
        "nu": (o_mesh.nu, o_plain.nu), "metrics": (met_mesh, met_plain),
    }
    out["update_differences"] = {k: _largest_difference(*v) for k, v in pairs.items()}
    out["update_close"] = all(
        torch.allclose(x.double(), y.double(), rtol=a.get("rtol", 1e-5), atol=0)
        for mine, theirs in pairs.values() for x, y in ((mine[k], theirs[k]) for k in mine)
    )
    return out


def _raise(mesh, a):
    from minigrid_tpu_torch.parallel.mesh import all_reduce

    if mesh.rank == a.get("rank", 1):
        raise RuntimeError(f"rank {mesh.rank} fails before the collective")
    all_reduce(mesh, torch.ones(1, device=mesh.device))
    return {}


MODES = {"basics": _basics, "rollout": _rollout, "resets": _resets, "update": _update, "learners": _learners,
         "meshless": _meshless, "raise": _raise}


def main(argv: list[str]) -> None:
    import torch.distributed as dist

    from minigrid_tpu_torch.parallel.mesh import make_mesh

    tmp, rank, world_size, backend, device = Path(argv[0]), int(argv[1]), int(argv[2]), argv[3], argv[4]
    spec = torch.load(tmp / "spec.pt", weights_only=False)
    mesh = make_mesh(
        None if device == "default" else device,
        None if backend == "default" else backend,
        init_method=f"file://{tmp / 'store'}",
        rank=rank,
        world_size=world_size,
        timeout=timedelta(seconds=spec["group_timeout"]),
    )
    try:
        # A mode may run twice under two names, "mode:label".
        out = {name: MODES[name.split(":")[0]](mesh, args) for name, args in spec["modes"].items()}
        torch.save(out, tmp / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
