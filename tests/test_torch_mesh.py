"""The port's data parallelism (``minigrid_tpu_torch/parallel/mesh.py``,
``scaling.py`` and the learners' mesh branches) on the CPU.

Each multi-process case spawns two gloo ranks through
``parallel/mp_worker.run_workers``, whose join is bounded.  The two-rank
PPO and IMPALA updates of the two halves of a trajectory are held to the
one-process update of the whole and to the JAX package's update over a
two-device mesh (conftest's virtual CPU devices) on the same trajectory.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.parallel.mesh import make_mesh as jax_make_mesh
from minigrid_tpu.parallel.reset_budget import resets_for
from minigrid_tpu.rl import impala as jimpala
from minigrid_tpu.rl import ppo as jppo
from minigrid_tpu.rl.rollout import collect_trajectory as j_collect_trajectory
from minigrid_tpu_torch.core.state import tree_leaves
from minigrid_tpu_torch.parallel import mesh as tmesh
from minigrid_tpu_torch.parallel import scaling
from minigrid_tpu_torch.parallel.mp_worker import run_workers
from minigrid_tpu_torch.parallel.vector import rollout_random
from minigrid_tpu_torch.rl import impala as timpala
from minigrid_tpu_torch.rl import ppo as tppo
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.rl.rollout import Trajectory
from torch_port_util import jax_learner_init, port_model, to_port, with_bias_noise

HIDDEN = 64
ENV_ID = "MiniGrid-Empty-5x5-v0"
N, T = 64, 16
# The two-rank update against the one-process update.  Each rank's gradient
# of a bf16 product is rounded to bf16 (2^-8 relative) before the ranks
# average it, where one process rounds the whole batch's, and later
# minibatches see parameters that differ by that: the moments agree to a
# small fraction of their tensor's largest, each parameter to a fraction of
# one Adam step (at most about the learning rate), the losses as the port's
# to JAX's.  A per-rank advantage normalisation moves most parameters by a
# whole step.  Counts are exact.
STEP_FRACTION = 0.25
MOMENT_FRACTION = 2.0**-5
JAX_LOSS_RTOL, JAX_COUNT_RTOL = 1e-3, 1e-6
ROLLOUTS = {
    # Per-step regeneration; a short limit ends episodes within the run.
    "empty": dict(env_id=ENV_ID, max_steps=12, num_envs=16, steps=40, reset_seed=1, seed=2, return_states=True),
    # An expensive_reset family: each rank's plain path draws its own pool.
    "keycorridor": dict(env_id="MiniGrid-KeyCorridorS3R1-v0", max_steps=12, num_envs=16, steps=40, reset_seed=3,
                        seed=4, return_states=True),
}
LEARNERS = dict(env_id="MiniGrid-Empty-8x8-v0", num_envs=64, rollout_steps=4, num_minibatches=2, hidden=HIDDEN,
                ppo_steps=2, impala_steps=1, seed=0, sabotage=True, time_allreduce=True)


def _fake_mesh(rank, world_size=2):
    """A mesh for what needs no collective: its rank, size and device."""
    return tmesh.Mesh(None, rank, world_size, torch.device("cpu"))


def _jax_sharded(jmesh, tree, spec):
    return jax.tree.map(lambda x: jax.device_put(x, NamedSharding(jmesh, spec)), tree)


def _port_traj(traj) -> Trajectory:
    return Trajectory(*(torch.from_numpy(np.array(x)) for x in traj))


@pytest.fixture(scope="module")
def ppo_case():
    """test_torch_ppo.py's ``jax_batch`` recipe (Empty-5x5, 64 envs x 16
    steps, hidden 64, nonzero biases, the behaviour logp moved off the
    policy) at 4 minibatches, with the second half's rewards shifted so that
    the halves' advantage means differ; and JAX's update of it over a
    two-device mesh, the trajectory sharded on its env axis."""
    config = jppo.PPOConfig(rollout_steps=T, num_minibatches=4)
    init_fn, step = jppo.make_ppo(mg.make(ENV_ID), config, hidden=HIDDEN)
    state = jax_learner_init(init_fn, jax.random.PRNGKey(0), N)
    params = jax.tree.map(jnp.asarray, with_bias_noise(jax.tree.map(np.array, state.params), 0))
    env_states, key, traj = step.rollout(params, state.env_states, state.key)
    rng = np.random.default_rng(1)
    reward = np.array(traj.reward)
    reward[:, N // 2 :] += 1.0
    traj = traj._replace(
        logp=traj.logp + rng.normal(0, 0.3, traj.logp.shape).astype(np.float32), reward=jnp.asarray(reward)
    )
    jmesh = jax_make_mesh(jax.devices()[:2])
    _, mstep = jppo.make_ppo(mg.make(ENV_ID), config, hidden=HIDDEN, mesh=jmesh)
    _, _, _, want = jax.jit(mstep.update)(
        _jax_sharded(jmesh, params, P()), _jax_sharded(jmesh, state.opt_state, P()), key,
        _jax_sharded(jmesh, env_states, P("data")), _jax_sharded(jmesh, traj, P(None, "data")),
    )
    return config, jax.tree.map(np.array, params), env_states, traj, jax.tree.map(np.array, want)


@pytest.fixture(scope="module")
def impala_case():
    """A JAX IMPALA train step over a two-device mesh (Empty-5x5, 64 envs x
    16 steps, hidden 64, nonzero biases, 2 minibatches), and the trajectory
    it collected, rebuilt shard by shard from the keys its mesh branch
    folds (``minigrid_tpu/rl/rollout.py:73-124``)."""
    config = jimpala.IMPALAConfig(rollout_steps=T, num_minibatches=2)
    env = mg.make(ENV_ID)
    jmesh = jax_make_mesh(jax.devices()[:2])
    init_fn, train_step = jimpala.make_impala(env, config, hidden=HIDDEN, mesh=jmesh)
    state = init_fn(jax.random.PRNGKey(5), N)
    state = state._replace(params=jax.tree.map(jnp.asarray, with_bias_noise(jax.tree.map(np.array, state.params), 3)))
    sharded = state._replace(
        params=_jax_sharded(jmesh, state.params, P()), opt_state=_jax_sharded(jmesh, state.opt_state, P()),
        env_states=_jax_sharded(jmesh, state.env_states, P("data")), key=_jax_sharded(jmesh, state.key, P()),
    )
    new_state, want = jax.jit(train_step)(sharded)
    model = jimpala.ActorCritic(hidden=HIDDEN, num_actions=env.num_actions)

    def policy_apply(p, obs, direction):
        return model.apply(p, obs, direction, packed=True)

    @jax.jit
    def shard(states, key):
        final, _, traj = j_collect_trajectory(env, policy_apply, state.params, states, key, T, resets_for(env, T))
        return final, traj

    _, k_use = jax.random.split(state.key)
    half = N // 2
    parts = [
        shard(jax.tree.map(lambda x: x[d * half : (d + 1) * half], state.env_states), jax.random.fold_in(k_use, d))
        for d in range(2)
    ]
    final = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *(p[0] for p in parts))
    traj = jax.tree.map(lambda *xs: np.concatenate(xs, axis=1), *(p[1] for p in parts))
    for got, rebuilt in zip(jax.tree.leaves(new_state.env_states), jax.tree.leaves(final)):
        np.testing.assert_array_equal(np.asarray(got), rebuilt)
    return config, jax.tree.map(np.array, state.params), final, traj, jax.tree.map(np.array, want)


def _one_process_update(make, config, params, env_states, traj):
    model = port_model(params)
    _, step = make(mgt.make(ENV_ID), config, hidden=HIDDEN)
    model, opt_state, metrics = step.update(model, tppo.adam_init(model), to_port(env_states), _port_traj(traj))
    return {"params": model.state_dict(), "mu": opt_state.mu, "nu": opt_state.nu, "count": opt_state.count,
            "metrics": metrics}


@pytest.fixture(scope="module")
def cases(ppo_case, impala_case):
    """The one-process port updates of both cases, and one spawn of two
    gloo ranks running every mode whose ranks must succeed."""
    ppo_config = tppo.PPOConfig(**ppo_case[0]._asdict())
    impala_config = timpala.IMPALAConfig(**impala_case[0]._asdict())
    one = {
        "ppo": _one_process_update(tppo.make_ppo, ppo_config, *ppo_case[1:4]),
        "impala": _one_process_update(timpala.make_impala, impala_config, *impala_case[1:4]),
    }
    spec = {"basics": {}, **{f"rollout:{k}": v for k, v in ROLLOUTS.items()}}
    spec["resets"] = dict(env_id="MiniGrid-DoorKey-5x5-v0", rollout_steps=T)
    for learner, config, case in (("ppo", ppo_config, ppo_case), ("impala", impala_config, impala_case)):
        spec[f"update:{learner}"] = dict(
            learner=learner, env_id=ENV_ID, hidden=HIDDEN, config=config._asdict(),
            params=port_model(case[1]).state_dict(), env_states=to_port(case[2]), traj=_port_traj(case[3]),
        )
    spec["learners"] = LEARNERS
    return one, run_workers(spec, 2, device="cpu", timeout=240).results


def test_shard_batch_gives_each_rank_its_contiguous_rows():
    tree = {"a": torch.arange(12).reshape(6, 2), "t": Trajectory(*(torch.arange(18).reshape(3, 6) for _ in range(7)))}
    for rank in range(3):
        mesh = _fake_mesh(rank, 3)
        local = tmesh.shard_batch(mesh, tree)
        assert torch.equal(local["a"], tree["a"][2 * rank : 2 * rank + 2])
        traj = tmesh.shard_batch(mesh, tree["t"], axis=1)
        assert isinstance(traj, Trajectory) and torch.equal(traj.obs, tree["t"].obs[:, 2 * rank : 2 * rank + 2])


def test_shard_batch_and_sharded_reset_refuse_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch(_fake_mesh(0, 4), torch.zeros(6, 3))
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.sharded_reset(mgt.make(ENV_ID), _fake_mesh(1, 4), torch.Generator().manual_seed(0), 10)


def test_sharded_reset_draws_each_rank_from_its_generator():
    # Every rank holds the caller's generator in the same state.
    env = mgt.make("MiniGrid-DoorKey-5x5-v0")
    shards = [tmesh.sharded_reset(env, _fake_mesh(r), torch.Generator().manual_seed(7), 32)[1] for r in range(2)]
    for rank, states in enumerate(shards):
        _, want = env.reset(16, tmesh.rank_generator(torch.Generator().manual_seed(7), rank), "cpu")
        assert states.step_count.shape == (16,)
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(states), tree_leaves(want)))
    assert not torch.equal(shards[0].grid, shards[1].grid)


def test_rank_generators_are_fixed_by_the_seed_and_differ_by_rank():
    draws = [torch.rand(4, generator=tmesh.rank_generator(torch.Generator().manual_seed(3), r)) for r in (0, 1, 0)]
    assert torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[1])
    # The caller's generator advances: a second rank generator from it is
    # another stream, as a second env.reset from it is.
    gen = torch.Generator().manual_seed(3)
    first, second = (torch.rand(4, generator=tmesh.rank_generator(gen, 0)) for _ in range(2))
    assert torch.equal(first, draws[0]) and not torch.equal(first, second)


def test_a_reset_and_each_rollout_after_it_draw_streams_of_their_own():
    """One generator through ``sharded_reset`` and two
    ``sharded_rollout_fused`` calls, as through ``env.reset`` and two
    ``rollout_random`` calls without a mesh: the rollout does not replay the
    reset's stream, and the second rollout not the first's."""
    env = mgt.make(ENV_ID, max_steps=12)
    mesh = tmesh.make_mesh(device="cpu")  # a group of this process alone
    try:
        gen = torch.Generator().manual_seed(5)
        _, states = tmesh.sharded_reset(env, mesh, gen, 16)
        first, second = (tmesh.sharded_rollout_fused(env, mesh, states, gen, 20)[0] for _ in range(2))
    finally:
        torch.distributed.destroy_process_group()
    # The reset's own rank generator, used again for the rollout.
    replayed = rollout_random(env, states, tmesh.rank_generator(torch.Generator().manual_seed(5), 0), 20)[0]

    def same(x, y):
        return all(torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(x), tree_leaves(y)))

    assert not same(first, replayed) and not same(first, second)


def test_replicate_broadcasts_rank_0(cases):
    _, results = cases
    want = results[0]["basics"]
    for out in results:
        b = out["basics"]
        assert torch.equal(b["x"], torch.arange(4.0))
        assert torch.equal(b["tree"]["f"], torch.zeros(3)) and torch.equal(b["tree"]["i"], torch.zeros(2, 2, dtype=torch.int64))
        assert all(torch.equal(v, want["model"][k]) for k, v in b["model"].items())
    # One broadcast a dtype: the tensor, the tree's float and its int leaf,
    # and the network's 1588 float32 parameters (hidden 8, a 3x3 view, 3
    # actions) in one buffer.
    assert want["log"][:4] == [("broadcast", 16), ("broadcast", 12), ("broadcast", 32), ("broadcast", 6352)]


def test_reductions_sum_max_and_min(cases):
    _, results = cases
    for out in results:
        assert out["basics"]["reductions"] == {"sum": 3.0, "max": 2.0, "min": 1.0}
        assert out["basics"]["log"][4:] == [("all_reduce(sum)", 4), ("all_reduce(max)", 4), ("all_reduce(min)", 4)]


@pytest.mark.parametrize("name", list(ROLLOUTS))
def test_sharded_rollout_is_each_shard_alone_with_summed_totals(cases, name):
    _, results = cases
    a = ROLLOUTS[name]
    env = mgt.make(a["env_id"], max_steps=a["max_steps"])
    totals = []
    for rank, out in enumerate(r[f"rollout:{name}"] for r in results):
        # The worker held its shard to rollout_random from its rank
        # generator; here the same from this process, from the seeds.
        assert out["equal"]
        _, states = env.reset(8, tmesh.rank_generator(torch.Generator().manual_seed(a["reset_seed"]), rank), "cpu")
        gen = tmesh.rank_generator(torch.Generator().manual_seed(a["seed"]), rank)
        final, total_r, episodes, used = rollout_random(env, states, gen, a["steps"])
        assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(out["final"]), tree_leaves(final)))
        assert out["local"] == (float(total_r), int(episodes), int(used))
        totals.append(out["local"])
    assert sum(t[1] for t in totals) > 0
    for out in (r[f"rollout:{name}"] for r in results):
        assert out["total_reward"] == totals[0][0] + totals[1][0]
        assert out["episodes"] == totals[0][1] + totals[1][1]
        assert out["max_used"] == max(totals[0][2], totals[1][2]) <= out["capacity"]
    if name == "keycorridor":
        # Each rank's pool is sized from its own 8 envs.
        assert results[0][f"rollout:{name}"]["max_used"] > 0
        assert results[0][f"rollout:{name}"]["capacity"] == results[1][f"rollout:{name}"]["capacity"]


@pytest.mark.parametrize("learner", ["ppo", "impala"])
def test_two_rank_update_equals_the_one_process_update(cases, ppo_case, impala_case, learner):
    one, results = cases
    want = one[learner]
    lr = (ppo_case if learner == "ppo" else impala_case)[0].learning_rate
    outs = [r[f"update:{learner}"] for r in results]
    for out in outs:
        assert out["count"] == want["count"]
        for k, w in want["params"].items():
            np.testing.assert_allclose(out["params"][k], w.detach(), rtol=0, atol=STEP_FRACTION * lr, err_msg=k)
        for part in ("mu", "nu"):
            for k, w in want[part].items():
                atol = MOMENT_FRACTION * float(w.abs().max())
                np.testing.assert_allclose(out[part][k], w, rtol=0, atol=atol, err_msg=f"{part} {k}")
        for k in ("pg_loss", "value_loss", "entropy"):
            np.testing.assert_allclose(float(out["metrics"][k]), float(want["metrics"][k]), rtol=JAX_LOSS_RTOL, err_msg=k)
        for k in ("reward_per_step", "episodes", "max_episodes_per_chunk", "resets_per_chunk", "replayed"):
            np.testing.assert_allclose(float(out["metrics"][k]), float(want["metrics"][k]), rtol=JAX_COUNT_RTOL, err_msg=k)
    # The ranks' parameters and moments are bit for bit alike.
    for part in ("params", "mu", "nu"):
        assert all(torch.equal(v, outs[1][part][k]) for k, v in outs[0][part].items())


@pytest.mark.parametrize("learner", ["ppo", "impala"])
def test_two_rank_update_equals_jax_over_a_two_device_mesh(cases, ppo_case, impala_case, learner):
    _, results = cases
    want = (ppo_case if learner == "ppo" else impala_case)[4]
    got = results[0][f"update:{learner}"]["metrics"]
    for k in ("pg_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=JAX_LOSS_RTOL, err_msg=k)
    for k in ("reward_per_step", "episodes", "max_episodes_per_chunk"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=JAX_COUNT_RTOL, err_msg=k)


def test_the_halves_advantage_means_differ(ppo_case):
    """The case the PPO tests rest on: a per-rank normalisation would
    normalise each half by its own mean, which is far from the whole's."""
    config, params, env_states, traj, _ = ppo_case
    _, step = tppo.make_ppo(mgt.make(ENV_ID), tppo.PPOConfig(**config._asdict()), hidden=HIDDEN)
    model = port_model(params)
    with torch.no_grad():
        _, last = model(tppo.bootstrap_observation(mgt.make(ENV_ID), to_port(env_states), True),
                        torch.from_numpy(np.array(env_states.agent_dir)), packed=True)
        t = _port_traj(traj)
        adv = step.gae(t.value, t.reward, t.done, last)
    for b in range(4):
        rows = adv[4 * b : 4 * b + 4]
        first, second = rows[:, : N // 2].mean(), rows[:, N // 2 :].mean()
        assert float(second - first) > float(rows.std()), (b, float(first), float(second))


@pytest.mark.parametrize("learner", ["ppo", "impala"])
def test_a_train_step_logs_only_the_expected_collectives(cases, learner):
    _, results = cases
    for out in (r["learners"] for r in results):
        expected = out[f"{learner}_expected"]
        steps = out[learner] if learner == "impala" else out[learner][:-1]
        for step in steps:
            assert step["log"] == expected
            assert all(math.isfinite(step["metrics"][k]) for k in ("pg_loss", "value_loss", "entropy"))
            # Timed inside the step: one reading a collective.
            assert len(step["collective_ms"]) == len(expected) and all(ms >= 0 for ms in step["collective_ms"])


def test_a_step_that_all_reduces_the_observations_is_flagged(cases):
    _, results = cases
    for out in (r["learners"] for r in results):
        step = out["ppo"][-1]
        assert step["log"] != out["ppo_expected"]
        assert [e for e in step["log"] if e not in out["ppo_expected"]] == [("all_reduce(sum)", step["traj_bytes"]["obs"])]


def test_parameters_and_adam_state_stay_equal_on_every_rank(cases):
    _, results = cases
    for out in (r["learners"] for r in results):
        assert all(step["same"] for learner in ("ppo", "impala") for step in out[learner])
    assert results[0]["learners"]["ppo"][0]["metrics"] == results[1]["learners"]["ppo"][0]["metrics"]


def test_learner_resets_grow_the_same_r_on_both_ranks(cases):
    _, results = cases
    r0 = results[0]["resets"]["r0"]
    for out in (r["resets"] for r in results):
        # Only rank 0's chunk came near R; both grow it to twice its most.
        assert out["r"] == 2 * r0 and out["metrics"]["max_episodes_per_chunk"] == r0
        assert out["metrics"]["resets_per_chunk"] == r0 and out["metrics"]["replayed"] == 0


def test_gradient_bytes_at_hidden_256():
    model = ActorCritic(256, 7, 7, device="cpu")
    assert scaling.param_bytes(model) == 1_280_032
    config = tppo.PPOConfig()
    assert scaling.gradient_bytes_per_step(model, config, 2) == 8 * 1_280_032
    assert scaling.expected_collectives(model, config)[2:10] == [("all_reduce(sum)", 1_280_032)] * 8


def test_modeled_efficiency_formula():
    model = ActorCritic(64, 7, 7, device="cpu")
    pb = scaling.param_bytes(model)
    assert scaling.modeled_ppo_efficiency(0.05, model, 8, 1, 1) == 1.0
    eff = scaling.modeled_ppo_efficiency(0.05, model, 8, 2, 4, link_bytes_per_sec=1e9)
    assert eff == pytest.approx(0.05 / (0.05 + 2 * 3 / 4 * pb * 16 / 1e9), rel=1e-12)
    assert scaling.modeled_ppo_efficiency(0.05, model, 8, 1, 8) < scaling.modeled_ppo_efficiency(0.05, model, 8, 1, 2)


def test_dryrun_multichip_on_the_cpu():
    outs = tmesh.dryrun_multichip(2, device="cpu")
    assert len(outs) == 2 and outs[0]["ppo"][0]["metrics"] == outs[1]["ppo"][0]["metrics"]


@pytest.mark.parametrize(
    "spec",
    [
        {"raise": {}},
        # A pool run out on both ranks: the check after the reduction.
        {"rollout": dict(env_id="MiniGrid-KeyCorridorS3R1-v0", max_steps=3, resets_per_chunk=1, num_envs=16,
                         steps=12, reset_seed=1, seed=2)},
    ],
    ids=["one-rank-raises", "pool-exhausted"],
)
def test_a_failing_rank_fails_every_rank_without_a_hang(spec):
    run = run_workers(spec, 2, device="cpu", timeout=60, group_timeout=20, check=False)
    assert all(rc not in (0, None) for rc in run.rcs), run.logs
    assert run.seconds < 40
    want = "fails before the collective" if "raise" in spec else "reset pool exhausted"
    assert want in "".join(run.logs)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the machine has a GPU")
def test_make_mesh_refuses_cuda_without_a_gpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(device="cuda", backend="gloo")


def test_nccl_refuses_two_ranks_on_one_device(tmp_path):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two devices: two NCCL ranks take one each")
    with pytest.raises(ValueError, match="two\\s+ranks would share one"):
        tmesh.make_mesh(backend="nccl", rank=0, world_size=2, init_method=f"file://{tmp_path / 'store'}")
    assert not torch.distributed.is_initialized()


def test_a_one_rank_mesh_learner_is_the_mesh_less_learner_bit_for_bit():
    """At one rank the reductions change nothing: the mesh learner's
    collection from a generator state is the mesh-less collection from it,
    and its update of that trajectory the mesh-less update."""
    from minigrid_tpu_torch.parallel.mp_worker import MODES

    mesh = tmesh.make_mesh(device="cpu")  # a group of this process alone
    try:
        out = MODES["meshless"](mesh, dict(env_id="MiniGrid-Empty-8x8-v0", num_envs=32, rollout_steps=8,
                                           num_minibatches=2, hidden=HIDDEN, ppo_steps=2, seed=3))
    finally:
        torch.distributed.destroy_process_group()
    assert [s["count"] for s in out["ppo"]] == [2, 4] and all(s["same"] for s in out["ppo"])
    assert out["collection_equal"]
    assert out["update_differences"] == {"params": 0.0, "mu": 0.0, "nu": 0.0, "metrics": 0.0}
