"""The port's profiler (``minigrid_tpu_torch/tools/profiler.py``) on the CPU.

Its registry against JAX's (``tools/profiler.py``), its import free of JAX,
every measure function at a tiny size through the plain versions, the
replay-free certificate of its chains, its refusal to write a trend off the
card, the committed trend file, and the bound accounting it shares with
``chip_smoke.py`` (``tools/roofline.py``) against the figures ``PERF.md``
records.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.ops.actor_rollout import repack_actor_params
from minigrid_tpu_torch.rl.model import ActorCritic
from minigrid_tpu_torch.tools import profiler as prof
from minigrid_tpu_torch.tools import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two chain lengths and one rep: the control flow, not a measurement.
TINY = dict(device="cpu", lengths=(1, 2), reps=1)
NO_LAUNCHES = {k: 0 for k in prof.launch_counts()}


def _jax_profiler():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, ROOT)
    import profiler

    return profiler


def test_registry_equals_jax():
    jax_prof = _jax_profiler()
    assert set(prof.TREND_METRICS) == set(jax_prof.TREND_METRICS)
    assert prof.BENCH_KEY_TO_TREND == jax_prof.BENCH_KEY_TO_TREND
    assert prof.BENCH_INFORMATIONAL_KEYS == jax_prof.BENCH_INFORMATIONAL_KEYS


def test_bench_keys_all_floored():
    """The twin of tests/test_tools.py::test_bench_keys_all_floored: every
    key of bench.TRACKED maps to a metric the port floors."""
    _jax_profiler()
    import bench

    floored = set(prof.TREND_METRICS) | set(prof.PPO_TREND_KEYS)
    assert set(prof.BENCH_KEY_TO_TREND.values()) <= floored
    for key, _, _ in bench.TRACKED:
        assert prof.BENCH_KEY_TO_TREND.get(key) in floored, key


def test_the_profiler_imports_no_jax():
    code = (
        "import sys, minigrid_tpu_torch.tools.profiler\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'minigrid_tpu', 'profiler'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _rate(r):
    return [r.value], r.launches, r.covered


def _learner(t):
    return [1 / t.single_s, 1 / t.marginal_s, 1 / t.pipelined_s], t.launches, None


def _breakdown(b):
    return [b["sps_full"], b["sps_if_rollout_only"], b["sps_if_update_only"]], b["launches_per_step"], b["covered"]


def _ablate(b):
    return [b["sps_full"], b["sps_kernel_only"], b["levels_per_sec_gen"]], b["launches"], b["covered"]


MEASURES = {
    "rollout_sps": lambda: _rate(prof.rollout_sps(prof.ENV_ID, 64, 8, **TINY)),
    "rollout_sps_pool": lambda: _rate(prof.rollout_sps("MiniGrid-DoorKey-5x5-v0", 64, 8, **TINY)),
    "obs_sps": lambda: _rate(prof.obs_sps(prof.ENV_ID, 64, 8, **TINY)),
    "obs_sps_stepwise": lambda: _rate(prof.obs_sps(prof.ENV_ID, 64, 8, fused=False, **TINY)),
    "actor_collect_sps": lambda: _rate(prof.actor_collect_sps(prof.ENV_ID, 64, 8, hidden=64, **TINY)),
    "ppo_times": lambda: _learner(prof.ppo_times(64, 8, hidden=64, **TINY)),
    "impala_times": lambda: _learner(prof.impala_times(64, 8, hidden=64, **TINY)),
    "ppo_breakdown": lambda: _breakdown(prof.ppo_breakdown(64, 8, hidden=64, **TINY)),
    "babyai_ablate": lambda: _ablate(prof.babyai_ablate("BabyAI-GoToLocal-v0", 64, 8, **TINY)),
    "wfc_levels_per_sec": lambda: _rate(prof.wfc_levels_per_sec("MazeSimple", 2, 6, **TINY)),
}


@pytest.mark.parametrize("name", sorted(MEASURES))
def test_each_measure_runs_on_the_cpu(name):
    """Finite positive rates, no kernel launched (the plain versions run on
    CPU tensors), and every chain within its certified budget."""
    rates, launches, covered = MEASURES[name]()
    assert all(math.isfinite(r) and r > 0 for r in rates), rates
    assert launches == NO_LAUNCHES
    if covered is not None:
        observed, capacity = covered
        assert 0 <= observed <= max(capacity, 0)


def test_launch_and_sync_intercept():
    assert 0.0 <= prof.tunnel_rtt("cpu", reps=2) < 1.0


@pytest.mark.parametrize("fused", [True, False], ids=["cache", "pool"])
def test_a_budget_cut_to_one_level_fails_the_certificate(fused):
    """GoToDoor ends an episode on every done or toggle: with R cut to 1
    (a one-level cache an env, or a pool of one level an env) some env of
    64 ends more episodes in 16 steps, and the timed chain's certificate
    raises."""
    match = "reset cache exhausted" if fused else "reset pool exhausted"
    with pytest.raises(AssertionError, match=match):
        prof.rollout_sps("MiniGrid-GoToDoor-5x5-v0", 64, 16, fused=fused, resets=1, **TINY)


def test_refresh_trend_refuses_off_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(prof, "TREND_PATH", str(tmp_path / "perf_trend.json"))
    monkeypatch.setattr(prof, "TREND_HISTORY_PATH", str(tmp_path / "perf_trend_history.json"))
    with pytest.raises(RuntimeError, match="card's trend"):
        prof.refresh_trend(device="cpu")
    assert not any(tmp_path.iterdir())


def test_the_committed_trend_covers_the_registry_from_a_card():
    with open(prof.TREND_PATH) as f:
        trend = json.load(f)
    assert "NVIDIA" in trend["card"] and " W" in trend["card"]
    rates = trend["rates"]
    missing = (set(prof.TREND_METRICS) | set(prof.PPO_TREND_KEYS)) - set(rates)
    assert not missing
    assert all(math.isfinite(v) and v > 0 for v in rates.values())
    with open(prof.TREND_HISTORY_PATH) as f:
        assert json.load(f)[-1] == trend


def test_bounds_reproduce_the_recorded_figures():
    """PERF.md's bound column: K2 on Empty-8x8 at 8192 x 128, hidden 256,
    0.7363 ms; K3 forward and backward at a PPO minibatch, M = 131072,
    0.0741 ms; all bound by operations."""
    env = mgt.make(prof.ENV_ID)
    gen = torch.Generator().manual_seed(0)
    _, states = env.reset(8192, gen, "cpu")
    weights = repack_actor_params(ActorCritic(256, env.num_actions, env.agent_view_size, gen, "cpu"))
    ms, by = roofline.actor_bound(env, states, weights, 128, 8192, 1)
    assert (f"{ms:.4f}", by) == ("0.7363", "operations")
    for direction in ("fwd", "bwd"):
        ms, by = roofline.embed_bound(131072, 49, 256, direction)
        assert (f"{ms:.4f}", by) == ("0.0741", "operations")
