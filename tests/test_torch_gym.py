"""The port's gymnasium shim (``minigrid_tpu_torch/compat/gym.py``) on the
CPU: gymnasium's ``check_env``, seeded determinism, ``SyncVectorEnv`` and
registration (twins of ``tests/test_compat.py``), pickling mid-episode in
both modes (``tests/test_pickle.py``), the human render under SDL's dummy
driver (``tests/test_human_render.py``), the view queries and unseeded
resets against the JAX package's shim in parity mode, normal mode's
``torch.Generator`` levels, and the shim without gymnasium."""

from __future__ import annotations

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

os.environ.setdefault("SDL_VIDEODRIVER", "dummy")

import gymnasium as gym  # noqa: E402

from minigrid_tpu.compat.gym import gym_make as jax_gym_make  # noqa: E402
from minigrid_tpu_torch.compat import gym as tgym  # noqa: E402
from minigrid_tpu_torch.compat import gym_make, register_gymnasium_envs  # noqa: E402

# tests/test_compat.py's ids.
SAMPLE_IDS = [
    "MiniGrid-Empty-5x5-v0",
    "MiniGrid-DoorKey-5x5-v0",
    "MiniGrid-Dynamic-Obstacles-5x5-v0",
    "BabyAI-GoToRedBallGrey-v0",
]
# tests/test_pickle.py's ids.
PICKLE_IDS = [
    "MiniGrid-Empty-8x8-v0",
    "MiniGrid-DoorKey-8x8-v0",
    "MiniGrid-KeyCorridorS3R2-v0",
    "BabyAI-GoToLocal-v0",
    "MiniGrid-Dynamic-Obstacles-8x8-v0",
]
PREFIX = "TorchPort/"


def make_cpu(env_id, **kwargs):
    return gym_make(env_id, device="cpu", **kwargs)


def _obs_equal(a, b):
    assert np.array_equal(a["image"], b["image"])
    assert a["direction"] == b["direction"]
    assert a["mission"] == b["mission"]


@pytest.mark.parametrize("env_id", SAMPLE_IDS)
@pytest.mark.parametrize("parity", [False, True])
def test_check_env(env_id, parity):
    from gymnasium.utils.env_checker import check_env

    env = make_cpu(env_id, render_mode="rgb_array", parity=parity)
    check_env(env, skip_render_check=False)
    env.close()


@pytest.mark.parametrize("env_id", SAMPLE_IDS)
def test_seeded_determinism_via_shim(env_id):
    """Same seed => identical 30-step rollouts (reference test_envs.py:51-103)."""
    a, b = make_cpu(env_id), make_cpu(env_id)
    obs_a, _ = a.reset(seed=123)
    obs_b, _ = b.reset(seed=123)
    _obs_equal(obs_a, obs_b)
    rng = np.random.default_rng(0)
    for _ in range(30):
        act = int(rng.integers(0, a.action_space.n))
        oa, ra, ta, tra, _ = a.step(act)
        ob, rb, tb, trb, _ = b.step(act)
        _obs_equal(oa, ob)
        assert (ra, ta, tra) == (rb, tb, trb)
        if ta or tra:
            _obs_equal(a.reset()[0], b.reset()[0])


def test_sync_vector_env():
    """The reference's only multi-env path (tests/test_envs.py:317-329)."""
    num_envs = 4
    env = gym.vector.SyncVectorEnv([lambda: make_cpu("MiniGrid-Empty-5x5-v0") for _ in range(num_envs)])
    obs, _ = env.reset(seed=0)
    assert obs["image"].shape == (num_envs, 7, 7, 3)
    obs, rewards, terms, truncs, _ = env.step(np.zeros(num_envs, dtype=np.int64))
    assert rewards.shape == (num_envs,)
    env.close()


def test_gymnasium_registry_under_a_prefix():
    """All 177 ids register under a prefix, once; literal gymnasium.make
    works with the device passed through; an id another package registered
    (the same names without the prefix, here a stand-in) raises."""
    n = register_gymnasium_envs(PREFIX)
    assert n in (0, 177)
    assert register_gymnasium_envs(PREFIX) == 0
    ours = [k for k in gym.envs.registry if k.startswith(PREFIX)]
    assert len(ours) == 177
    env = gym.make(PREFIX + "MiniGrid-Empty-5x5-v0", device="cpu")
    obs, _ = env.reset(seed=0)
    assert obs["image"].shape == (7, 7, 3)
    env.step(2)
    assert isinstance(env.unwrapped, tgym.GymnasiumMiniGrid)
    env.close()
    clash = "TorchPortClash/"
    gym.register(id=clash + "MiniGrid-Empty-5x5-v0", entry_point=lambda **kw: None)
    try:
        with pytest.raises(ValueError, match="already registered"):
            register_gymnasium_envs(clash)
    finally:
        for key in [k for k in gym.envs.registry if k.startswith(clash)]:
            del gym.envs.registry[key]


@pytest.mark.parametrize("env_id", PICKLE_IDS)
@pytest.mark.parametrize("parity", [False, True])
def test_pickle_gym_shim_mid_episode(env_id, parity):
    """The shim pickles mid-episode (the state and the generator travel on
    the CPU, pygame handles are dropped) and the clone's next transitions,
    and the reset after them, match exactly."""
    env = make_cpu(env_id, parity=parity)
    env.reset(seed=5)
    for a in (2, 0, 2):
        env.step(a)
    clone = pickle.loads(pickle.dumps(env))
    assert clone.device == env.device and clone.hash() == env.hash()
    for a in (2, 1, 2, 2, 5, 2):
        o1, r1, t1, u1, _ = env.step(a)
        o2, r2, t2, u2, _ = clone.step(a)
        _obs_equal(o1, o2)
        assert (r1, t1, u1) == (r2, t2, u2)
        if t1 or u1:
            break
    _obs_equal(env.reset()[0], clone.reset()[0])
    env.close()
    clone.close()


def test_human_mode_opens_window_and_ticks():
    pytest.importorskip("pygame")
    env = make_cpu("MiniGrid-Empty-5x5-v0", render_mode="human")
    assert "human" in env.metadata["render_modes"]
    env.reset(seed=1)
    # Reference opens the window during reset (minigrid_env.py:151-152).
    assert env.window is not None
    assert env.window.get_size() == (640, 640)
    for action in (0, 2, 1):
        env.step(action)
    # clock.tick() ran (minigrid_env.py:781) — a Clock was created.
    assert env.clock is not None
    # render() returns None in human mode (the frame goes to the window).
    assert env.render() is None
    env.close()
    assert env.window is None


def test_human_mode_mission_caption_drawn():
    """The window must contain non-background pixels (grid + caption blit)."""
    pygame = pytest.importorskip("pygame")
    env = make_cpu("MiniGrid-DoorKey-5x5-v0", render_mode="human", screen_size=320)
    env.reset(seed=7)
    arr = pygame.surfarray.array3d(env.window)
    assert arr.shape == (320, 320, 3)
    assert (arr != 255).any(), "window is blank — nothing was blitted"
    env.close()


def test_rgb_array_frame_equals_jax_in_parity_mode():
    """rgb_array mode draws no window, and its frame equals the JAX shim's
    on the same parity episode."""
    env = make_cpu("MiniGrid-DoorKey-5x5-v0", render_mode="rgb_array", parity=True)
    ref = jax_gym_make("MiniGrid-DoorKey-5x5-v0", render_mode="rgb_array", parity=True)
    env.reset(seed=1)
    ref.reset(seed=1)
    for action in (None, 1, 2):
        if action is not None:
            env.step(action)
            ref.step(action)
        img = env.render()
        assert isinstance(img, np.ndarray) and img.ndim == 3 and img.shape[2] == 3
        np.testing.assert_array_equal(img, ref.render())
    assert env.window is None  # no pygame involvement
    env.close()


def test_view_query_api_equals_jax():
    """agent_sees / in_view / relative_coords / get_view_coords / front_pos
    / dir_vec / right_vec and the attribute surface equal the JAX shim's in
    parity mode on every cell of every step of a 40-step episode."""
    env_id = "MiniGrid-DoorKey-6x6-v0"
    ours = make_cpu(env_id, parity=True)
    ref = jax_gym_make(env_id, parity=True)
    ours.reset(seed=42)
    ref.reset(seed=42)
    rng = np.random.default_rng(0)
    for t in range(40):
        for name in ("dir_vec", "right_vec", "front_pos"):
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=f"{t} {name}")
        for name in ("agent_pos", "agent_dir", "step_count", "max_steps", "steps_remaining", "carrying", "mission"):
            assert getattr(ours, name) == getattr(ref, name), (t, name)
        assert ours.hash() == ref.hash() and str(ours) == str(ref)
        grid = ours.state.grid[0].numpy()
        for x in range(ours.env.width):
            for y in range(ours.env.height):
                assert ours.get_view_coords(x, y) == ref.get_view_coords(x, y), (t, x, y)
                assert ours.relative_coords(x, y) == ref.relative_coords(x, y), (t, x, y)
                assert ours.in_view(x, y) == ref.in_view(x, y), (t, x, y)
                if grid[x, y] & 0xFF == 1:  # the reference asserts on an empty cell in view
                    if ours.in_view(x, y):
                        with pytest.raises(ValueError):
                            ours.agent_sees(x, y)
                    else:
                        assert not ours.agent_sees(x, y)
                    continue
                assert ours.agent_sees(x, y) == ref.agent_sees(x, y), (t, x, y)
        a = int(rng.integers(0, 7))
        _, _, term, trunc, _ = ours.step(a)
        ref.step(a)
        if term or trunc:
            break


@pytest.mark.parametrize("env_id", ["MiniGrid-Dynamic-Obstacles-6x6-v0", "BabyAI-OpenTwoDoors-v0"])
def test_unseeded_resets_continue_the_stream_as_jax_does(env_id):
    """A seeded parity reset, steps, then three unseeded resets with steps
    between: each episode equals the JAX shim's, and so does the seeding
    stream (``np_random``)."""
    ours = make_cpu(env_id, parity=True)
    ref = jax_gym_make(env_id, parity=True)
    _obs_equal(ours.reset(seed=9)[0], ref.reset(seed=9)[0])
    assert ours.np_random.bit_generator.state == ref.np_random.bit_generator.state
    rng = np.random.default_rng(1)
    for episode in range(4):
        if episode:
            _obs_equal(ours.reset()[0], ref.reset()[0])
        assert ours.hash() == ref.hash(), episode
        for _ in range(10):
            a = int(rng.integers(0, 7))
            o1, r1, t1, u1, _ = ours.step(a)
            o2, r2, t2, u2, _ = ref.step(a)
            _obs_equal(o1, o2)
            assert (t1, u1) == (t2, u2) and abs(r1 - r2) <= 1e-6 * abs(r2)


def test_normal_mode_levels_come_from_seed_and_episode():
    """Normal mode draws each episode from a ``torch.Generator`` seeded by
    (seed, episode): the same pair gives the same level, the next episode
    another one, and a new seed restarts the count."""
    a, b = make_cpu("MiniGrid-FourRooms-v0"), make_cpu("MiniGrid-FourRooms-v0")
    a.reset(seed=3)
    first = a.hash()
    b.reset(seed=3)
    assert b.hash() == first
    a.reset()
    second = a.hash()
    assert second != first
    b.reset(seed=3)
    b.reset()
    assert b.hash() == second
    a.reset(seed=3)
    assert a.hash() == first
    assert tgym._episode_seed(3, 0) != tgym._episode_seed(3, 1) != tgym._episode_seed(4, 1)


def test_np_random_follows_gymnasium_contract():
    """``reset(seed=s)`` installs the generator gymnasium's
    ``Env.reset(seed=s)`` installs; the JAX shim's equals it too."""
    from gymnasium.utils import seeding

    for seed in (0, 1, 7, 42, 99):
        ours = make_cpu("MiniGrid-Empty-5x5-v0")
        ours.reset(seed=seed)
        want, want_seed = seeding.np_random(seed)
        assert ours.np_random_seed == want_seed
        assert ours.np_random.bit_generator.state == want.bit_generator.state


def test_step_before_reset_raises():
    with pytest.raises(RuntimeError, match="reset"):
        make_cpu("MiniGrid-Empty-5x5-v0").step(0)


def _gym_module_without_gymnasium(monkeypatch):
    """A fresh copy of ``compat/gym.py`` imported where gymnasium cannot
    be."""
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    spec = importlib.util.spec_from_file_location("_shim_without_gymnasium", tgym.__file__)
    module = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, module)  # so that its class pickles
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("parity", [False, True])
def test_the_shim_runs_without_gymnasium(monkeypatch, parity):
    module = _gym_module_without_gymnasium(monkeypatch)
    with pytest.raises(ImportError):
        import gymnasium  # noqa: F401
    assert module._EnvBase is object
    env = module.gym_make("MiniGrid-DoorKey-5x5-v0", parity=parity, device="cpu")
    assert not hasattr(env, "action_space") and not hasattr(env, "observation_space")
    obs, info = env.reset(seed=11)
    assert obs["image"].shape == (7, 7, 3) and info == {}
    want = make_cpu("MiniGrid-DoorKey-5x5-v0", parity=parity)
    _obs_equal(obs, want.reset(seed=11)[0])
    assert env.np_random.bit_generator.state == want.np_random.bit_generator.state
    for a in (1, 2, 2, 0, 2):
        o1, r1, t1, u1, _ = env.step(a)
        o2, r2, t2, u2, _ = want.step(a)
        _obs_equal(o1, o2)
        assert (r1, t1, u1) == (r2, t2, u2)
    assert env.render().shape == want.render().shape
    clone = pickle.loads(pickle.dumps(env))
    assert clone.hash() == env.hash()


def test_the_state_lives_on_the_device_asked_for():
    env = make_cpu("BabyAI-GoToLocal-v0", parity=True)
    env.reset(seed=0)
    assert env.device == torch.device("cpu")
    assert env.state.grid.device.type == "cpu" and env.state.extra["instr"].gridm.device.type == "cpu"
    # No device means the card; without one the shim refuses, it does not
    # fall back to the CPU.
    if torch.cuda.is_available():
        assert tgym.GymnasiumMiniGrid(env.env).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tgym.GymnasiumMiniGrid(env.env)


def test_the_new_modules_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter where jax, the JAX package, gymnasium and
    networkx cannot be imported, the shim, the three parity modules and the
    inspection helpers import, and a WFC and a BabyAI parity episode run."""
    import subprocess

    code = (
        "import sys\n"
        "for m in ('jax', 'minigrid_tpu', 'gymnasium', 'networkx'):\n"
        "    sys.modules[m] = None\n"
        "from minigrid_tpu_torch.compat import gym_make, parity, parity_babyai, parity_wfc\n"
        "from minigrid_tpu_torch.utils import debug\n"
        "for env_id in ('MiniGrid-WFC-ObstaclesBlackdots-v0', 'BabyAI-GoToLocal-v0'):\n"
        "    env = gym_make(env_id, parity=True, device='cpu')\n"
        "    env.reset(seed=1)\n"
        "    env.step(2)\n"
        "    print(debug.state_hash(env.state))\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
        "assert not [k for k in loaded if k in ('jax', 'minigrid_tpu') or k.startswith(('jax.', 'minigrid_tpu.'))]\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert len(out.stdout.split()) == 2
