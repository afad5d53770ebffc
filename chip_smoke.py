#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``minigrid_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure raises and exits non-zero:

1. require a CUDA device; print the card (``nvidia-smi``) and versions;
2. build the whole-rollout kernel from ``minigrid_tpu_torch/ops/csrc``;
3. replay the recorded reference transitions (``tests/golden/steps_*.npz``,
   ``process_vis.npz``) through the port's core step, observation and
   occlusion on the card: integers bit-exact, rewards to rtol 1e-6;
4. hold the kernel against its plain PyTorch version on random object-rich
   states (doors, keys, balls, boxes, carried objects, occlusion, R=2 cache,
   short episodes): every state field, the cache slots used, the
   observation checksum and the episode count exact, the reward total to
   rtol 1e-5;
5. the slice: ``make("MiniGrid-Empty-8x8-v0")``, 65536 envs reset on the card,
   ``rollout_random`` for 256 steps and the observation-consuming
   ``fused_rollout`` through the kernel, each checked against the plain
   version on the same actions and cache, the reset cache certified, and
   both timed against the plain version.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu_torch.core.constants import pack_carry, see_behind, unpack_grid
from minigrid_tpu_torch.core.env import MiniGridEnv
from minigrid_tpu_torch.core.obs import gen_obs_image, process_vis
from minigrid_tpu_torch.core.state import FIELDS, new_state
from minigrid_tpu_torch.core.step import core_step
from minigrid_tpu_torch.ops import _build
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel.reset_budget import assert_chain_covered, resets_for
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_random
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
ENV_ID = "MiniGrid-Empty-8x8-v0"
NUM_ENVS = 65536
NUM_STEPS = 256
REWARD_RTOL = 1e-5  # totals are summed in another order by the two versions
GOLDEN_REWARD_RTOL = 1e-6


def check(ok: bool, message: str) -> None:
    """Fail the run (an explicit raise: ``assert`` vanishes under -O)."""
    if not ok:
        raise AssertionError(message)


def phase(n: int, text: str) -> None:
    print(f"phase {n}: {text}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def replay_goldens(device) -> int:
    """Phase 3: every recorded transition through core_step and
    gen_obs_image, and every recorded view through process_vis."""
    files = sorted(GOLDEN.glob("steps_*.npz"))
    check(len(files) == 10, f"expected 10 step fixtures, found {len(files)}")
    for path in files:
        with np.load(path) as z:
            d = {k: z[k] for k in z.files}
        t = {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}
        state = new_state(
            t["grid_pre"], t["pos_pre"], t["dir_pre"], int(d["max_steps"]), contains=t["contains_pre"]
        )
        c = t["carry_pre"].int()
        state = state.replace(
            carrying=pack_carry(c[:, 0], c[:, 1], c[:, 2], c[:, 3]),
            step_count=t["step_count_pre"].int(),
        )
        state, reward = core_step(state, t["action"])
        obs = gen_obs_image(state, int(d["agent_view_size"]), bool(d["see_through_walls"]))
        got = {
            "grid_post": unpack_grid(state.grid),
            "contains_post": torch.stack([state.contains & 0xFF, (state.contains >> 8) & 0xFF], -1),
            "pos_post": state.agent_pos,
            "dir_post": state.agent_dir,
            "carry_post": torch.stack([(state.carrying >> s) & 0xFF for s in (0, 8, 16, 24)], -1),
            "reward": reward,
            "terminated": state.terminated,
            "truncated": state.truncated,
            "obs_image": obs,
        }
        for key, value in got.items():
            want = d[key]
            have = value.cpu().numpy().astype(want.dtype)
            if key == "reward":
                # The reference computed it in float64; the port, like the
                # JAX package, in float32 (its golden test's rtol).
                ok = np.allclose(have, want, rtol=GOLDEN_REWARD_RTOL, atol=0)
            else:
                ok = np.array_equal(have, want)
            check(ok, f"{path.name}: {key} differs from the fixture")
    with np.load(GOLDEN / "process_vis.npz") as z:
        grids = torch.from_numpy(z["grids"]).to(device).int()
        masks = z["masks"]
    vis = process_vis(see_behind(grids[..., 0], grids[..., 2]))
    check(np.array_equal(vis.cpu().numpy(), masks), "process_vis differs from the fixture")
    return len(files)


def compare(kernel_out, plain_out, what: str) -> float:
    """Assert the kernel's rollout equals the plain version's; returns the
    largest absolute difference over everything compared."""
    final_k, rew_k, done_k, chk_k, used_k = kernel_out
    final_p, rew_p, done_p, chk_p, used_p = plain_out
    for f in FIELDS:
        a, b = getattr(final_k, f), getattr(final_p, f)
        check(a.shape == b.shape and torch.equal(a, b), f"{what}: state field {f} differs")
    for name, a, b in (("done count", done_k, done_p), ("checksum", chk_k, chk_p), ("used", used_k, used_p)):
        check(int(a) == int(b), f"{what}: {name} {int(a)} != {int(b)}")
    rk, rp = float(rew_k), float(rew_p)
    check(np.isfinite(rk) and abs(rk - rp) <= REWARD_RTOL * abs(rp), f"{what}: reward {rk} != {rp}")
    return abs(rk - rp)


def synthetic_check(device) -> float:
    """Phase 4: kernel against plain version on object-rich states."""
    rng = np.random.default_rng(7)
    n, t, r, w, h = 4096, 64, 2, 9, 7
    states = state_from_numpy(random_states(rng, (n,), w, h), device)
    cache = state_from_numpy(random_states(rng, (n, r), w, h, fresh=True), device)
    actions = torch.from_numpy(rng.integers(0, 7, (t, n), dtype=np.int32)).to(device)
    err = 0.0
    for see_through in (False, True):
        env = MiniGridEnv(w, h, max_steps=100, see_through_walls=see_through)
        for compute_obs in (True, False):
            kernel = fr.fused_rollout_core(env, states, cache, actions, compute_obs)
            plain = fr.fused_rollout_reference(env, states, cache, actions, compute_obs)
            what = f"synthetic see_through={see_through} compute_obs={compute_obs}"
            err = max(err, compare(kernel, plain, what))
            check(int(kernel[2]) > 0, f"{what}: no episode ended")
    return err


def replay_rollout(env, states, snapshot, compute_obs: bool, resets: int):
    """The plain version on the actions and cache that ``fused_rollout``
    drew from a generator in state ``snapshot``."""
    device = states.device
    gen = torch.Generator(device=device)
    gen.set_state(snapshot)
    n = states.step_count.shape[0]
    actions = torch.randint(
        0, env.num_actions, (NUM_STEPS, n), generator=gen, device=device, dtype=torch.int32
    )
    cache = env.batch_reset_cache(n, resets, gen, device)
    return actions, cache, fr.fused_rollout_reference(env, states, cache, actions, compute_obs)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    phase(1, f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load_library("fused_rollout")
    seconds, log = _build.BUILD_INFO.get("fused_rollout", (0.0, ""))
    ptxas = " | ".join(line.strip() for line in log.splitlines() if "registers" in line)
    phase(2, f"kernel built in {seconds:.1f} s (loaded after {time.perf_counter() - t0:.1f} s); {ptxas}")

    n_files = replay_goldens(device)
    phase(3, f"{n_files} step fixtures and process_vis bit-exact on {device}")

    max_err = synthetic_check(device)
    phase(4, f"kernel == plain version on object-rich states (max abs err {max_err})")

    # -- Phase 5: the slice, through the entry points a user calls --------
    env = mgt.make(ENV_ID)
    check(fused_eligible(env, device), f"{ENV_ID} must take the kernel on {device}")
    resets = resets_for(env, NUM_STEPS)
    gen = torch.Generator(device=device).manual_seed(0)
    _, states = env.reset(NUM_ENVS, gen, device)
    snap_random = gen.get_state()
    fr.KERNEL_LAUNCHES = 0
    out_random = rollout_random(env, states, gen, NUM_STEPS)
    snap_obs = gen.get_state()
    out_obs = fr.fused_rollout(env, states, gen, NUM_STEPS, resets, compute_obs=True)
    torch.cuda.synchronize()
    launches = fr.KERNEL_LAUNCHES
    check(launches == 2, f"the slice launched the kernel {launches} times, expected 2")

    final, total_r, total_done, max_used = out_random
    check(final.grid.shape == (NUM_ENVS, env.width, env.height), "final grid shape")
    # Every episode truncates by step 256 = max_steps, so each env ends one.
    check(np.isfinite(float(total_r)) and int(total_done) >= NUM_ENVS, "episode count")
    check(int(final.step_count.max()) < env.max_steps, "a step count past max_steps")
    _, _, plain_random = replay_rollout(env, states, snap_random, False, resets)
    # rollout_random consumes no observations: its checksum is 0, as the
    # plain version's without compute_obs.
    kernel_random = (final, total_r, total_done, torch.zeros(()), max_used)
    max_err = max(max_err, compare(kernel_random, plain_random, "rollout_random"))
    actions, cache, plain_obs = replay_rollout(env, states, snap_obs, True, resets)
    max_err = max(max_err, compare(out_obs, plain_obs, "fused_rollout compute_obs"))

    def chunk(carry):
        st, g = carry
        st, r, d, mu = rollout_random(env, st, g, NUM_STEPS)
        return (st, g), (r, d, mu)

    observed = assert_chain_covered(chunk, (states, gen), resets, env)
    phase(
        5,
        f"{ENV_ID} {NUM_ENVS} envs x {NUM_STEPS} steps: {launches} kernel launches, "
        f"outputs == plain version, {int(total_done)} episodes, reward {float(total_r)}, "
        f"R={resets} covered (max used {int(max_used)}, chain {observed})",
    )

    times = {}
    for compute_obs in (False, True):
        k = partial(fr.fused_rollout_core, env, states, cache, actions, compute_obs)
        p = partial(fr.fused_rollout_reference, env, states, cache, actions, compute_obs)
        # In turns, plain, kernel, kernel, plain; the faster of each pair.
        tp1, tk1, tk2, tp2 = time_ms(p, 2), time_ms(k, 10), time_ms(k, 10), time_ms(p, 2)
        times[compute_obs] = (min(tk1, tk2), min(tp1, tp2))
    steps = NUM_ENVS * NUM_STEPS
    for compute_obs, (k_ms, p_ms) in times.items():
        print(
            f"steps/s ({card}) {ENV_ID} {NUM_ENVS}x{NUM_STEPS} compute_obs={compute_obs}: "
            f"kernel {steps / k_ms * 1e3:.6g} ({k_ms:.4f} ms), plain {steps / p_ms * 1e3:.6g} "
            f"({p_ms:.4f} ms), kernel/plain speed {p_ms / k_ms:.3g}x",
            flush=True,
        )

    k_ms, p_ms = times[False]
    summary = {
        "kernels": [
            {
                "name": "fused_rollout",
                "route": "cuda",
                "source": "minigrid_tpu_torch/ops/csrc/fused_rollout.cu",
                "replaces": "minigrid_tpu/ops/fused_rollout.py:335",
                "launches": launches,
                "max_abs_err": max_err,
                "ms": k_ms,
                "plain_ms": p_ms,
            }
        ]
    }
    print(json.dumps(summary), flush=True)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)


if __name__ == "__main__":
    main()
