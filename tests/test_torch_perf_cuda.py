"""Opt-in perf lane of the port on the GPU: every floored rate against the
card's trend.

The port's twin of tests/test_perf_tpu.py.  The floors are ``TREND_RATIO``
times the rates in ``minigrid_tpu_torch/tools/perf_trend.json``, which
``python -m minigrid_tpu_torch.tools.profiler trend`` writes from a run on
the card, and the test list is the profiler's registry (``TREND_METRICS``)
and its three PPO rates, the same table the trend is measured from: a
metric cannot be tracked without a floor.  The trend names the card and
power limit it was measured on; a card set to a lower limit runs slower.

Skipped unless ``RUN_CUDA_PERF=1`` is set and a card is present.  It
imports no JAX, so it runs where JAX is not installed:

    RUN_CUDA_PERF=1 python -m pytest tests/test_torch_perf_cuda.py --noconftest -p no:cacheprovider

JAX's ``test_kernel_under_shard_map_real_chip`` has no twin here: the port's
mesh (``parallel/mesh.py``) runs each kernel on each rank of
``torch.distributed``, which ``tests/test_torch_mesh.py`` holds on the CPU
and ``chip_smoke.py``'s phase 34 on the card.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from minigrid_tpu_torch.tools.profiler import (
    PPO_TREND_KEYS,
    TREND_METRICS,
    TREND_PATH,
    card_line,
    fresh_allocator,
    ppo_times,
)

pytestmark = pytest.mark.cuda

# A metric fails below this share of its trend value.
TREND_RATIO = 0.6


@pytest.fixture
def opted_in():
    if not os.environ.get("RUN_CUDA_PERF"):
        pytest.skip("the GPU perf lane: set RUN_CUDA_PERF=1 on a machine with an NVIDIA GPU")


@pytest.fixture
def card(opted_in):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    print(card_line(torch.device("cuda")), "against the trend of", _trend()["card"])
    # Each metric from a fresh allocator, as the trend measured it.
    fresh_allocator()


def _trend() -> dict:
    with open(TREND_PATH) as f:
        return json.load(f)


def _assert_trend(key: str, value: float) -> None:
    rates = _trend()["rates"]
    assert key in rates, f"{key} has no trend value: run `python -m minigrid_tpu_torch.tools.profiler trend` on the card"
    floor = TREND_RATIO * rates[key]
    assert value > floor, (
        f"{key} regressed: {value:.6g} < {floor:.6g} (= {TREND_RATIO} x the trend's {rates[key]:.6g}); refresh "
        "minigrid_tpu_torch/tools/perf_trend.json with the profiler's trend mode if the change is accepted"
    )


@pytest.mark.parametrize("metric", sorted(TREND_METRICS))
def test_metric_trend(card, metric):
    _assert_trend(metric, TREND_METRICS[metric]())


def test_ppo_trend(card):
    """The three PPO rates share one measurement."""
    times = ppo_times()
    for key, seconds in zip(PPO_TREND_KEYS, (times.single_s, times.marginal_s, times.pipelined_s)):
        _assert_trend(key, 8192 * 128 / seconds)


def test_trend_file_covers_registry(opted_in):
    """Every floored metric has a trend value, so a metric added without
    refreshing the trend fails the lane at once."""
    missing = [k for k in (*TREND_METRICS, *PPO_TREND_KEYS) if k not in _trend()["rates"]]
    assert not missing, f"metrics without floors: {missing}; run the profiler's trend mode on the card"

