"""The port's user tools on the CPU: the per-env benchmark CLI
(``minigrid_tpu_torch/benchmark.py``) and manual control
(``minigrid_tpu_torch/manual_control.py``), twins of ``tests/test_tools.py``'s
``test_benchmark_smoke`` and ``test_manual_control_keys``; one render under
SDL's dummy driver; and the entry points refusing the CPU unless asked."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import minigrid_tpu_torch as mgt  # noqa: E402
from minigrid_tpu_torch import benchmark as bench  # noqa: E402
from minigrid_tpu_torch.compat.gym import _episode_seed  # noqa: E402
from minigrid_tpu_torch.manual_control import KEY_TO_ACTION, ManualControl  # noqa: E402
from minigrid_tpu_torch.utils.demos import generate_demo  # noqa: E402

TINY = dict(num_resets=2, num_frames=2, num_envs=8, num_steps=4)


class Event:
    def __init__(self, key):
        self.key = key


def test_benchmark_smoke(capsys):
    r = bench.benchmark("MiniGrid-Empty-5x5-v0", device="cpu", **TINY)
    assert r["env_id"] == "MiniGrid-Empty-5x5-v0"
    assert r["reset_ms"] > 0
    assert r["world_render_fps"] > 0
    assert r["agent_view_fps"] > 0
    assert r["env_steps_per_sec"] > 0
    out = bench.main(["--env-id", "MiniGrid-LavaGapS5-v0", "--device", "cpu"] + [
        f"--{k.replace('_', '-')}={v}" for k, v in TINY.items()
    ])
    lines = capsys.readouterr().out.strip().split("\n")
    assert out["env_id"] == "MiniGrid-LavaGapS5-v0" and len(lines) == 5
    assert lines[0] == "env_id: MiniGrid-LavaGapS5-v0"
    assert lines[4].startswith("batched env-steps/s (8 envs): ")


def test_manual_control_keys(monkeypatch):
    """Drive ManualControl with fake key events, the display stubbed out
    (reference: tests/test_scripts.py:18-49)."""
    env = mgt.make("MiniGrid-Empty-5x5-v0")
    mc = ManualControl(env, seed=42, device="cpu")
    frames = []
    monkeypatch.setattr(mc, "render", lambda: frames.append(mc.frame()))
    mc.reset()
    start = (int(mc.state.agent_x[0]), int(mc.state.agent_y[0]), int(mc.state.agent_dir[0]))

    mc.key_handler(Event("left"))
    assert int(mc.state.agent_dir[0]) == (start[2] - 1) % 4
    mc.key_handler(Event("up"))
    mc.key_handler(Event("space"))
    assert int(mc.state.step_count[0]) == 3
    mc.key_handler(Event("f1"))  # not an action: printed, nothing stepped
    assert int(mc.state.step_count[0]) == 3
    mc.key_handler(Event("backspace"))
    assert int(mc.state.step_count[0]) == 0
    assert (int(mc.state.agent_x[0]), int(mc.state.agent_y[0]), int(mc.state.agent_dir[0])) == start
    # A reset and three steps drew, and so did the seeded reset.
    assert len(frames) == 5 and all(f.shape == (5 * 32, 5 * 32, 3) and f.dtype == np.uint8 for f in frames)
    np.testing.assert_array_equal(frames[0], frames[-1])
    assert not np.array_equal(frames[0], frames[1])
    mc.key_handler(Event("escape"))
    assert mc.closed
    assert set(KEY_TO_ACTION) == {"left", "right", "up", "space", "pageup", "pagedown", "tab", "left shift", "enter"}


def test_manual_control_keys_run_without_pygame(monkeypatch):
    """Where pygame cannot be imported (the GPU machine), the controller
    and its key handler run with the display stubbed, escape included."""
    monkeypatch.setitem(sys.modules, "pygame", None)
    mc = ManualControl(mgt.make("MiniGrid-Empty-5x5-v0"), seed=42, device="cpu")
    monkeypatch.setattr(mc, "render", lambda: None)
    mc.reset()
    for key in ("left", "up", "backspace", "escape"):
        mc.key_handler(Event(key))
    assert mc.closed and int(mc.state.step_count[0]) == 0
    with pytest.raises(ImportError):
        mc.start()


def test_manual_control_episodes_follow_the_shims_seeding():
    """Unseeded, each reset draws from (a random base seed, the episode
    number) through the shim's derivation; the episode ends re-reset."""
    env = mgt.make("MiniGrid-Empty-Random-5x5-v0")
    mc = ManualControl(env, device="cpu")
    mc.render = lambda: None
    np.random.seed(3)
    base = np.random.randint(0, 2**31)
    np.random.seed(3)
    mc.reset()
    _, want = env.reset(1, torch.Generator().manual_seed(_episode_seed(base, 0)))
    assert torch.equal(mc.state.grid, want.grid) and torch.equal(mc.state.agent_pos, want.agent_pos)
    assert mc._episode == 1
    # Walking into the goal ends the episode and resets at once.
    for _ in range(200):
        before = mc._episode
        mc.key_handler(Event("up"))
        if mc._episode > before:
            break
        mc.key_handler(Event("right"))
    assert mc._episode == 2 and int(mc.state.step_count[0]) == 0


def test_manual_control_renders_under_the_dummy_driver():
    pygame = pytest.importorskip("pygame")
    env = mgt.make("MiniGrid-DoorKey-5x5-v0")
    mc = ManualControl(env, seed=7, screen_size=320, device="cpu")
    mc.reset()
    assert mc.window is not None and mc.window.get_size() == (320, 320)
    mc.key_handler(Event("left"))
    arr = pygame.surfarray.array3d(mc.window)
    assert arr.shape == (320, 320, 3) and (arr != 0).any()
    mc.close()
    assert mc.window is None and mc.closed


def test_entry_points_refuse_the_cpu_unless_asked():
    """With no device the entry points take the card; without one they
    raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")
    env = mgt.make("BabyAI-GoToRedBallGrey-v0")
    with pytest.raises(RuntimeError):
        bench.benchmark("MiniGrid-Empty-5x5-v0", **TINY)
    with pytest.raises(RuntimeError):
        generate_demo(env, 0)
    with pytest.raises(RuntimeError):
        ManualControl(env, seed=0)
