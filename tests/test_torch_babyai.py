"""BabyAI's GoTo levels and verifier in the PyTorch port, against the JAX
package and the original's recorded episodes.

* The verifier replays the 16 recorded fixtures (``tests/golden/verifier_*``,
  8 levels, normal and done-actions mode; the pattern of
  tests/test_verifier_parity.py): every step's termination exactly and its
  reward to rtol 1e-6.  That covers GoTo, Pickup, Open, PutNext and the
  sequence combinators, which the ext carries.
* The ext's plain twin (``instr_block.BabyAIFusedExt.post_step`` on the
  packed words and planes) against ``instr.verify_step`` on the same
  recorded transitions: the instruction state, the reward and the
  termination at every step.
* The rollout kernel's plain version against the JAX package's Pallas kernel
  in interpret mode on GoToLocal (8 steps), GoTo (4 steps),
  PutNextS5N2Carrying (8 steps: the agent starts with the object to move)
  and MiniBossLevel (4 steps: every leaf kind and combinator), on the same
  states and R=2 cache, in both verifier modes: the final state with its
  ``InstrState``, the done count, the checksum and ``max_used`` bit for bit,
  the reward total to rtol 1e-6 (XLA's FMA, ROADMAP queue 3).  JAX's
  generator makes the levels, but MiniBossLevel's are the port's, carried
  across by the bridge (JAX's LevelGen generator compiles for ~45 s).
* The actor kernel's plain collector against JAX's interpreted actor kernel
  on GoToLocal, held to the three contracts of ``check_trajectory``.
* Every one of the 34 GoTo ids (GoToSeq's two from ``levelgen.py``) resets
  and steps at N=4; mission text equal to JAX's for the same instruction.

Each JAX reference runs once per module (module-scoped fixtures): its
interpreted kernels take 10-16 s each on the CPU.
"""

from __future__ import annotations

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.envs.babyai.core.text import babyai_mission_text as j_mission_text
from minigrid_tpu.ops.actor_rollout import B as JAX_BLOCK
from minigrid_tpu.ops.actor_rollout import HEAD_ROWS
from minigrid_tpu.ops.actor_rollout import fused_actor_rollout as j_fused_actor_rollout
from minigrid_tpu.ops.fused_rollout import fused_rollout_core as j_fused_rollout_core
from minigrid_tpu_torch.core.roomgrid import RoomGridBuilder
from minigrid_tpu_torch.core.state import new_state, tree_leaves
from minigrid_tpu_torch.core.step import core_step, success_reward
from minigrid_tpu_torch.envs.babyai.core.instr import (
    S_FAILURE,
    S_SUCCESS,
    InstrState,
    empty_instr,
    set_desc,
    set_leaf,
    set_top,
    verify_step,
)
from minigrid_tpu_torch.envs.babyai.core.level import RoomGridLevel
from minigrid_tpu_torch.envs.babyai.core.text import encode_babyai_mission
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.chunked import cat_trees
from babyai_port_util import one_torch_thread
from babyai_port_util import to_jax as babyai_to_jax
from torch_port_util import assert_states_equal, flax_params, jax_to_numpy, port_model
from torch_port_util import to_port as _to_port

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
VERIFIER_FILES = sorted(glob.glob(os.path.join(GOLDEN_DIR, "verifier_*.npz")))
N, R = 1024, 2
# (env id, steps, seed): tests/test_fused_rollout.py's BabyAI cases.
K1_CASES = {
    "gotolocal": ("BabyAI-GoToLocal-v0", 8, 0),
    "goto": ("BabyAI-GoTo-v0", 4, 2),
    "putnext_carrying": ("BabyAI-PutNextS5N2Carrying-v0", 8, 3),
    "minibosslevel": ("BabyAI-MiniBossLevel-v0", 4, 4),
}
# Cases whose levels the port generates (see the module docstring).
PORT_LEVELS = {"BabyAI-MiniBossLevel-v0"}
ACTOR_STEPS = 6
GOTO_IDS = sorted(i for i in mgt.registered_ids() if i.startswith("BabyAI-GoTo"))
# The bridge's type for BabyAI's structured extra leaf.
EXTRA_TYPES = {"instr": InstrState}


def to_port(state):
    return _to_port(state, extra_types=EXTRA_TYPES)


# -- the recorded episodes --------------------------------------------------------


def _episodes(path):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    eps = [
        {k[len(f"ep{i}_"):]: v for k, v in data.items() if k.startswith(f"ep{i}_")}
        for i in range(int(data["num_eps"]))
    ]
    return eps, bool(data.get("done_mode", False))


def _instr(rec, state, done_mode):
    """The recorded instruction on one episode's start state (JAX's
    tests/test_verifier_parity.py::_build_instr)."""
    room_mask = None
    if int(rec["room_size"]) > 0:
        b = RoomGridBuilder(int(rec["room_size"]), int(rec["num_rows"]), int(rec["num_cols"]))
        ai, aj = b.room_of_pos(state.agent_x, state.agent_y)
        room_mask = b.room_interior_mask(ai, aj)
    instr = empty_instr(1, *state.grid.shape[1:], done_mode=done_mode)
    instr = set_top(
        instr, int(rec["top"]), a_is_and=bool(rec["a_is_and"]), b_is_and=bool(rec["b_is_and"]), strict=bool(rec["strict"])
    )
    leaves = rec["leaves"]
    for leaf in range(4):
        if (leaves[leaf] == -1).all():
            continue
        instr = set_leaf(instr, leaf, int(leaves[leaf, 0]), strict=bool(leaves[leaf, 1]))
        for d, first in ((0, 2), (1, 5)):
            if d == 0 or leaves[leaf, 5] >= 0:
                desc = [int(v) for v in leaves[leaf, first : first + 3]]
                instr = set_desc(instr, leaf, d, state.grid, state.agent_pos, state.agent_dir, *desc, agent_room_mask=room_mask)
    return instr


def _start(path):
    """A file's episodes as one batch: start states with their instructions,
    the actions padded with 0 to the longest, and the recorded lengths."""
    eps, done_mode = _episodes(path)
    states = []
    for rec in eps:
        st = new_state(
            torch.from_numpy(rec["grid"][None]), torch.from_numpy(rec["pos"]), int(rec["dir"]), int(rec["max_steps"])
        )
        states.append(st.replace(extra={"instr": _instr(rec, st, done_mode)}))
    lengths = [len(rec["rewards"]) for rec in eps]
    actions = np.zeros((max(lengths), len(eps)), np.int32)
    for i, rec in enumerate(eps):
        actions[: len(rec["actions"]), i] = rec["actions"][: max(lengths)]
    return cat_trees(states), torch.from_numpy(actions), eps, lengths


def _verify(state, action):
    """One recorded transition: core step, verifier, the level's overlay."""
    prev = state
    stepped, reward = core_step(state, action)
    instr, status = verify_step(state.extra["instr"], prev, stepped, action)
    reward = torch.where(status == S_SUCCESS, success_reward(stepped.step_count, stepped.max_steps), reward)
    reward = torch.where(status == S_FAILURE, 0.0, reward)
    return prev, stepped.replace(terminated=stepped.terminated | (status != 0), extra={"instr": instr}), reward


@pytest.mark.parametrize("path", VERIFIER_FILES, ids=os.path.basename)
def test_verifier_replays_the_reference(path):
    state, actions, eps, lengths = _start(path)
    for t, action in enumerate(actions):
        _, state, reward = _verify(state, action)
        for i, rec in enumerate(eps):
            if t < lengths[i]:
                assert bool(state.terminated[i]) == bool(rec["terminated"][t]), (i, t)
                np.testing.assert_allclose(float(reward[i]), rec["rewards"][t], rtol=1e-6, err_msg=f"ep{i} t={t}")


@pytest.mark.parametrize("path", VERIFIER_FILES, ids=os.path.basename)
def test_ext_post_step_equals_verify_step(path):
    state, actions, _, _ = _start(path)
    ext = RoomGridLevel.fused_ext
    env = mgt.make("BabyAI-GoToLocal-v0")  # only the grid's size is read
    env.width, env.height = state.grid.shape[1:]
    for t, action in enumerate(actions):
        prev, want, want_reward = _verify(state, action)
        stepped, reward = core_step(prev, action)
        scal, planes = ext.pack_extra(env, stepped.extra), ext.pack_planes(env, stepped.extra)
        term, got_reward, scal, planes = ext.post_step(env, prev, stepped, action, reward, scal, planes)
        got = ext.unpack_extra(env, scal, planes)
        for (k, a), (_, b) in zip(tree_leaves(got), tree_leaves(want.extra)):
            assert torch.equal(a, b), f"t={t}: {k}"
        assert torch.equal(stepped.terminated | term, want.terminated) and torch.equal(got_reward, want_reward), t
        state = want


# -- the rollout kernel's plain version against JAX's interpreted kernel --------


def _done_mode(state):
    instr = state.extra["instr"]
    return state.replace(extra={"instr": instr.replace(done_mode=jnp.ones_like(instr.done_mode))})


@functools.cache
@functools.cache
def _jax_levels(env_id: str, seed: int):
    """JAX's states [N] and R=2 cache [N, R], from (R+1)N resets of one
    compiled generator, or of the port's for the ``PORT_LEVELS``."""
    if env_id in PORT_LEVELS:
        with one_torch_thread():
            _, port = mgt.make(env_id).reset((R + 1) * N, torch.Generator().manual_seed(seed))
        levels = babyai_to_jax(port)
    else:
        jenv = mg.make(env_id)
        _, levels = jax.jit(jax.vmap(jenv.reset))(jax.random.split(jax.random.PRNGKey(seed), (R + 1) * N))
    states = jax.tree.map(lambda a: a[:N], levels)
    return states, jax.tree.map(lambda a: a[N:].reshape((N, R) + a.shape[1:]), levels)


@pytest.fixture(scope="module", params=list(K1_CASES))
def k1_case(request):
    """JAX's states and R=2 cache, and its interpreted kernel's outputs with
    the verifier in normal and in done-actions mode (the same episodes with
    ``done_mode`` set, as ``BABYAI_DONE_ACTIONS`` makes them)."""
    env_id, steps, seed = K1_CASES[request.param]
    jenv = mg.make(env_id)
    states, cache = _jax_levels(env_id, seed)
    k3 = jax.random.PRNGKey(seed + 100)
    actions = jax.random.randint(k3, (steps, N), 0, jenv.num_actions, jnp.int32)
    out = {}
    for mode, f in (("normal", lambda s: s), ("done_actions", _done_mode)):
        out[mode] = (f(states), f(cache), j_fused_rollout_core(jenv, f(states), f(cache), actions, True, True))
    return env_id, np.array(actions), out


@pytest.mark.parametrize("mode", ["normal", "done_actions"])
def test_rollout_plain_version_matches_jax_kernel(k1_case, mode):
    env_id, actions, out = k1_case
    jstates, jcache, (jfinal, jrew, jdone, jchk, jused) = out[mode]
    before = fr.KERNEL_LAUNCHES
    final, rew, done, chk, used = fr.fused_rollout_core(
        mgt.make(env_id), to_port(jstates), to_port(jcache), torch.from_numpy(actions), True
    )
    assert fr.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert_states_equal(final, jfinal, f"{env_id} {mode}")  # the InstrState included
    assert (int(done), int(chk), int(used)) == (int(jdone), int(jchk), int(jused))
    np.testing.assert_allclose(float(rew), float(jrew), rtol=1e-6)
    assert int(done) > 0 and bool(final.extra["instr"].done_mode.all()) == (mode == "done_actions")


def test_ext_buffers_round_trip_the_instruction(k1_case):
    # The kernels' layout: 8 scalars [8, N] and 2 byte planes [2, W*H, N]
    # for the state, [R, ...] for the cache; unpacked, the InstrState of JAX.
    env_id, _, out = k1_case
    jstates, jcache, _ = out["normal"]
    env, states, cache = mgt.make(env_id), to_port(jstates), to_port(jcache)
    ext = fr.ext_buffers(env, states, cache, None, "test")
    cells = env.width * env.height
    assert ext.scal.shape == (8, N) and ext.planes.shape == (2, cells, N) and ext.planes.dtype == torch.uint8
    assert ext.cscal.shape == (R, 8, N) and ext.cplanes.shape == (R, 2, cells, N) and ext.ext_id == 6
    assert_states_equal(fr.with_extra(env, states, ext), jstates, env_id)


# -- the actor kernel's plain collector against JAX's interpreted one -----------


@pytest.fixture(scope="module")
def actor_case():
    """JAX's interpreted actor kernel on GoToLocal at hidden 64 with nonzero
    biases, its reset cache fixed to R=2 levels of the level's generator,
    and the sampling bits rebuilt from the keys it splits
    (``minigrid_tpu/ops/actor_rollout.py:464-474``)."""
    env_id, _, seed = K1_CASES["gotolocal"]
    env = mg.make(env_id)
    k_param, key = jax.random.split(jax.random.PRNGKey(6))
    states, cache = _jax_levels(env_id, seed)
    env.batch_reset_cache = lambda *_: cache  # the same levels on both sides
    packed = jax.vmap(lambda s: env.observation_packed(s).reshape(-1))(states)
    _, params = flax_params(np.asarray(packed), np.asarray(states.agent_dir), seed=int(k_param[1]) % 1000)
    final, traj = jax.block_until_ready(j_fused_actor_rollout(env, params, states, key, ACTOR_STEPS, R, interpret=True))
    _, k_noise, _ = jax.random.split(key, 3)
    bits = np.asarray(jax.random.bits(k_noise, (N // JAX_BLOCK, ACTOR_STEPS, HEAD_ROWS, JAX_BLOCK), jnp.uint32).astype(jnp.int32))
    noise = bits.transpose(1, 2, 0, 3).reshape(ACTOR_STEPS, HEAD_ROWS, N)[:, : env.num_actions]
    return {
        "env": mgt.make(env_id),
        "weights": ar.repack_actor_params(port_model(params)),
        "states": to_port(states),
        "cache": to_port(cache),
        "noise": torch.from_numpy(np.ascontiguousarray(noise)),
        "final": state_from_numpy(jax_to_numpy(final), extra_types=EXTRA_TYPES),
        "traj": {k: torch.from_numpy(np.array(v)) for k, v in traj.items()},
    }


def _check(case, final, traj):
    return ar.check_trajectory(case["env"], case["weights"], case["states"], case["cache"], case["noise"], final, traj)


def test_jax_actor_trajectory_meets_the_port_contracts(actor_case):
    traj = actor_case["traj"]
    assert traj["obs"].shape == (ACTOR_STEPS, N, 49) and int(traj["done"].sum()) > 0
    err, ties = _check(actor_case, actor_case["final"], traj)
    assert err <= 2e-2 and ties <= 0.01 * ACTOR_STEPS * N


def test_actor_plain_version_meets_the_same_contracts(actor_case):
    before = ar.KERNEL_LAUNCHES
    final, traj = ar.fused_actor_rollout_core(
        actor_case["env"], actor_case["weights"], actor_case["states"], actor_case["cache"], actor_case["noise"]
    )
    assert ar.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    _check(actor_case, final, traj)
    assert float((traj["action"][0] == actor_case["traj"]["action"][0]).float().mean()) >= 0.99
    np.testing.assert_array_equal(traj["obs"][0].numpy(), actor_case["traj"]["obs"][0].numpy())


def test_actor_contracts_compare_the_instruction(actor_case):
    final = actor_case["final"]
    instr = final.extra["instr"]
    wrong = final.replace(extra={"instr": instr.replace(gridm=instr.gridm ^ 1)})
    with pytest.raises(AssertionError, match="final extra instr.gridm"):
        _check(actor_case, wrong, actor_case["traj"])


# -- every id, and the mission text -------------------------------------------


@pytest.mark.parametrize("env_id", GOTO_IDS)
def test_every_goto_id_resets_and_steps(env_id):
    env = mgt.make(env_id)
    gen = torch.Generator().manual_seed(3)
    obs, state = env.reset(4, gen)
    assert obs["image"].shape == (4, 7, 7, 3) and state.mission.shape == (4, 44)
    assert state.grid.shape == (4, env.width, env.height)
    assert bool((state.max_steps > 0).all()) and bool((state.extra["instr"].leaf_kind[:, 0] == 1).all())
    for _ in range(3):
        obs, state, reward, term, trunc = env.step(state, torch.randint(0, 7, (4,), generator=gen, dtype=torch.int32), gen)
        assert reward.shape == (4,) and bool(torch.isfinite(reward).all())
    assert env.mission_text(state.mission[0]).startswith("go to ")


@pytest.mark.parametrize("case", list(K1_CASES))
def test_mission_text_matches_jax(case):
    env_id, _, seed = K1_CASES[case]
    states, _ = _jax_levels(env_id, seed)
    port = to_port(states)
    assert torch.equal(encode_babyai_mission(port.extra["instr"]), port.mission)
    env = mgt.make(env_id)
    texts = {env.mission_text(port.mission[i]) for i in range(64)}
    assert texts == {j_mission_text(np.asarray(states.mission[i])) for i in range(64)} and len(texts) > 5
    for i in range(64):
        assert env.mission_text(port.mission[i]) == j_mission_text(np.asarray(states.mission[i]))
