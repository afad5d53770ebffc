"""The port's oracle bot (``minigrid_tpu_torch/utils/babyai_bot.py``) against
the JAX package's, action for action, on the CPU.

Both bots start from JAX's own reset of one seed (the port's state is that
state as a batch of one, through the bridge) and step side by side through
their packages' ``step_env``: every suggested action equal, an exception
(``DisappearedBoxError``, the replan guard's ``RuntimeError``, a planner
invariant's ``AssertionError``) at the same step in both, the states equal
at the end.  The levels are seeds 0-7 of ``tests/test_babyai_bot.py``'s
``FAST_IDS``.
"""

from __future__ import annotations

import jax
import pytest
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from babyai_port_util import to_port
from minigrid_tpu.utils.babyai_bot import BabyAIBot as JaxBot
from minigrid_tpu_torch.utils.babyai_bot import BabyAIBot
from parity_port_util import batched
from torch_port_util import assert_states_equal

FAST_IDS = [
    "BabyAI-GoToObjS4-v0",
    "BabyAI-OpenRedDoor-v0",
    "BabyAI-PickupLoc-v0",
    "BabyAI-PutNextLocalS5N3-v0",
    "BabyAI-UnlockLocal-v0",
    "BabyAI-KeyCorridorS3R1-v0",
]
MAX_STEPS = 300
PLANNER_ERRORS = ("DisappearedBoxError", "RuntimeError", "AssertionError")


def replan(bot, state, last):
    """(action, None) or (None, the name of the planner error raised)."""
    try:
        return bot.replan(state, last), None
    except Exception as e:  # noqa: BLE001 - compared by name across the packages
        if type(e).__name__ not in PLANNER_ERRORS:
            raise
        return None, type(e).__name__


def side_by_side(env_id: str, seeds) -> list[tuple[int, str]]:
    """For each seed, both bots and both ``step_env``s for up to
    ``MAX_STEPS`` steps from JAX's reset of it; returns (steps, how the
    episode ended) of each."""
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    jreset, jstep = jax.jit(jenv.reset), jax.jit(jenv.step_env)
    episodes = []
    for seed in seeds:
        _, jstate = jreset(jax.random.PRNGKey(seed))
        tstate = to_port(batched(jstate))
        jbot, tbot = JaxBot(jenv, jstate), BabyAIBot(tenv, tstate)
        last = None
        outcome = "step limit"
        for k in range(MAX_STEPS):
            what = f"{env_id} seed {seed} step {k}"
            ja, jerr = replan(jbot, jstate, last)
            ta, terr = replan(tbot, tstate, last)
            assert terr == jerr, f"{what}: port {terr}, JAX {jerr}"
            if jerr is not None:
                outcome = jerr
                break
            assert ta == ja, f"{what}: port {ta}, JAX {ja}"
            jstate, jreward = jstep(jstate, ja)
            tstate, treward = tenv.step_env(tstate, torch.tensor([ta], dtype=torch.int32))
            last = ja
            if bool(jstate.terminated) or bool(jstate.truncated):
                outcome = f"reward {float(jreward):.4f}" if bool(jstate.terminated) else "truncated"
                assert float(treward[0]) == pytest.approx(float(jreward), rel=1e-6), f"{what}: reward"
                break
        assert_states_equal(tstate, batched(jstate), f"{env_id} seed {seed} after {k + 1} steps")
        episodes.append((k + 1, outcome))
    return episodes


@pytest.mark.parametrize("env_id", FAST_IDS)
def test_bot_gives_jax_bots_actions(env_id):
    # JAX's compiles dominate; each further seed costs a few hundred ms.
    episodes = side_by_side(env_id, range(8))
    assert all(steps >= 1 for steps, _ in episodes), episodes


def test_bot_takes_a_batch_of_one():
    env = mgt.make("BabyAI-GoToLocal-v0")
    _, states = env.reset(2, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="batch of one"):
        BabyAIBot(env, states)
    bot = BabyAIBot(env, states.map(lambda t: t[:1]))
    with pytest.raises(ValueError, match="batch of one"):
        bot.replan(states)
