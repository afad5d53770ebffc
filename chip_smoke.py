#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``minigrid_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure raises and exits non-zero:

1. require a CUDA device; print the card (``nvidia-smi``) and versions;
2. build every kernel from ``minigrid_tpu_torch/ops/csrc`` (one ``nvcc`` per
   source, side by side);
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
   both timed against the plain version;
6. the fused embed + dense-1 kernels at a PPO minibatch (131072 samples,
   hidden 256): forward against the plain version to atol 2e-2, backward
   against plain autograd to atol 2e-2 x max(1, |g|max), the backward twice
   bit-identical, each timed against the plain version;
7. the learner slice: ``make_ppo`` on ``MiniGrid-Empty-8x8-v0`` at 8192 envs x
   128 steps, hidden 256, three train steps through the kernels (the actor
   kernel once and the embed + dense-1 kernels 9 times forward and 8 times
   backward per step), the last step's trajectory (collected after two
   updates, with every bias nonzero) held to the three contracts of the
   actor kernel against the plain versions (env replay exact, policy logp
   and value to atol 1e-4, sampled actions equal where the top two Gumbel
   scores are more than 1e-2 apart), finite losses, and
   the env-steps/s of a train step, rollout and update apart, through the
   kernels and through the plain versions.

The second-to-last line is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
from minigrid_tpu_torch.ops import actor_rollout as ar
from minigrid_tpu_torch.ops import embed_dense as ed
from minigrid_tpu_torch.ops import fused_rollout as fr
from minigrid_tpu_torch.parallel.reset_budget import assert_chain_covered, resets_for
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_random
from minigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from minigrid_tpu_torch.utils.bridge import state_from_numpy
from minigrid_tpu_torch.utils.synthetic import random_states

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
ENV_ID = "MiniGrid-Empty-8x8-v0"
NUM_ENVS = 65536
NUM_STEPS = 256
REWARD_RTOL = 1e-5  # totals are summed in another order by the two versions
GOLDEN_REWARD_RTOL = 1e-6
# The learner slice: bench.py's PPO configuration.
PPO_ENVS = 8192
PPO_STEPS = 128
PPO_HIDDEN = 256
PPO_TRAIN_STEPS = 3
# One PPO minibatch: 16 time steps of 8192 envs.
EMBED_SAMPLES = PPO_STEPS // PPOConfig().num_minibatches * PPO_ENVS
# bf16 rounding of activations (forward) and of the plain version's bf16
# gradient (backward, scaled by max(1, |g|max)).
BF16_ATOL = 2e-2
# Sampled actions are compared where the top two Gumbel scores differ by more.
TIE_MARGIN = 1e-2
KERNELS = ("fused_rollout", "embed_dense", "actor_rollout")


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


def event_ms(fn) -> float:
    """Milliseconds between CUDA events around one call of ``fn``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def embed_inputs(device, m: int, seed: int):
    """Packed views of random object-rich 9x7 states (doors, keys, boxes,
    occlusion, carried objects), their directions, and random weights."""
    rng = np.random.default_rng(seed)
    env = MiniGridEnv(9, 7, max_steps=100)
    states = state_from_numpy(random_states(rng, (m,), 9, 7), device)
    packed = env.observation_packed(states)
    w1 = torch.from_numpy(rng.normal(0, 0.03, (packed.shape[1] * 20 + 4, PPO_HIDDEN)).astype(np.float32))
    b1 = torch.from_numpy(rng.normal(0, 0.1, PPO_HIDDEN).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1e-3, (m, PPO_HIDDEN)).astype(np.float32))
    return packed, states.agent_dir, w1.to(device), b1.to(device), dy.to(device, torch.bfloat16)


def embed_dense_check(device, card: str) -> list[dict]:
    """Phase 6: the embed + dense-1 kernels against their plain versions."""
    packed, direction, w1, b1, dy = embed_inputs(device, EMBED_SAMPLES, 11)
    out_k = ed.embed_dense1(w1, b1, packed, direction)
    out_p = ed.embed_dense1_reference(w1, b1, packed, direction)
    check(out_k.dtype == torch.bfloat16 and out_k.shape == (EMBED_SAMPLES, PPO_HIDDEN), "forward output")
    fwd_err = float((out_k.float() - out_p.float()).abs().max())
    check(fwd_err <= BF16_ATOL, f"embed_dense1 forward differs from the plain version by {fwd_err}")

    w1g, b1g = w1.clone().requires_grad_(), b1.clone().requires_grad_()
    dw_k, db_k = torch.autograd.grad(ed.embed_dense1(w1g, b1g, packed, direction), (w1g, b1g), dy)
    plain_out = ed.embed_dense1_reference(w1g, b1g, packed, direction)
    dw_p, db_p = torch.autograd.grad(plain_out, (w1g, b1g), dy, retain_graph=True)
    bwd_err = 0.0
    for name, got, want in (("dW1", dw_k, dw_p), ("db1", db_k, db_p)):
        err = float((got - want.float()).abs().max())
        scale = max(1.0, float(want.abs().max()))
        check(got.dtype == torch.float32 and err <= BF16_ATOL * scale, f"{name} differs by {err} (scale {scale})")
        bwd_err = max(bwd_err, err)
    dw_2, db_2 = ed._backward(packed, direction, dy)
    dw_3, db_3 = ed._backward(packed, direction, dy)
    check(torch.equal(dw_2, dw_3) and torch.equal(db_2, db_3), "the backward is not deterministic")
    check(torch.equal(dw_2, dw_k) and torch.equal(db_2, db_k), "the backward differs between calls")

    fwd_k = partial(ed.embed_dense1, w1, b1, packed, direction)
    fwd_p = partial(ed.embed_dense1_reference, w1, b1, packed, direction)
    bwd_k = partial(ed._backward, packed, direction, dy)
    bwd_p = partial(torch.autograd.grad, plain_out, (w1g, b1g), dy, retain_graph=True)
    times = {}
    for name, k, p in (("fwd", fwd_k, fwd_p), ("bwd", bwd_k, bwd_p)):
        tp1, tk1, tk2, tp2 = time_ms(p, 10), time_ms(k, 10), time_ms(k, 10), time_ms(p, 10)
        times[name] = (min(tk1, tk2), min(tp1, tp2))
        print(
            f"embed_dense1 {name} ({card}) M={EMBED_SAMPLES} H={PPO_HIDDEN}: kernel {times[name][0]:.4f} ms, "
            f"plain {times[name][1]:.4f} ms",
            flush=True,
        )
    phase(
        6,
        f"embed_dense1 at M={EMBED_SAMPLES}, H={PPO_HIDDEN}: forward max abs err {fwd_err}, "
        f"backward max abs err {bwd_err}, backward bit-identical across calls",
    )

    def entry(name, line, err, ms):
        return {
            "name": f"embed_dense1_{name}",
            "route": "cuda",
            "source": "minigrid_tpu_torch/ops/csrc/embed_dense.cu",
            "replaces": f"minigrid_tpu/ops/embed_dense.py:{line}",
            "launches": 0,
            "max_abs_err": err,
            "ms": ms[0],
            "plain_ms": ms[1],
        }

    return [entry("fwd", 103, fwd_err, times["fwd"]), entry("bwd", 115, bwd_err, times["bwd"])]


def ppo_slice(device, card: str) -> tuple[dict, dict]:
    """Phase 7: PPO on Empty-8x8 through the actor and embed + dense-1 kernels."""
    env = mgt.make(ENV_ID)
    config = PPOConfig(rollout_steps=PPO_STEPS)
    init_fn, train_step = make_ppo(env, config, hidden=PPO_HIDDEN)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_fn(gen, PPO_ENVS)
    check(ar.supports_fused_actor(env, device, PPO_ENVS, PPO_HIDDEN), "the slice must take the actor kernel")

    ar.KERNEL_LAUNCHES = 0
    ed.KERNEL_LAUNCHES.update(fwd=0, bwd=0)
    per_step = []
    for i in range(PPO_TRAIN_STEPS):
        before = (ar.KERNEL_LAUNCHES, ed.KERNEL_LAUNCHES["fwd"], ed.KERNEL_LAUNCHES["bwd"])
        if i < PPO_TRAIN_STEPS - 1:
            state, metrics = train_step(state)
        else:
            # The last step as its two phases, to keep its trajectory and
            # the parameters it was collected with: after the updates before
            # it, every bias is nonzero.
            model = copy.deepcopy(state.params)
            states0, snapshot = state.env_states, gen.get_state()
            final, traj = train_step.rollout(state.params, state.env_states, state.generator)
            _, opt_state, metrics = train_step.update(state.params, state.opt_state, final, traj)
            state = state._replace(opt_state=opt_state, env_states=final)
        after = (ar.KERNEL_LAUNCHES, ed.KERNEL_LAUNCHES["fwd"], ed.KERNEL_LAUNCHES["bwd"])
        per_step.append(tuple(a - b for a, b in zip(after, before)))
        losses = [float(metrics[k]) for k in ("pg_loss", "value_loss", "entropy")]
        check(all(np.isfinite(losses)), f"train step {i}: losses {losses}")
    torch.cuda.synchronize()
    launches_k2 = ar.KERNEL_LAUNCHES
    launches_k3 = dict(ed.KERNEL_LAUNCHES)
    want = (1, config.num_minibatches + 1, config.num_minibatches)
    check(all(p == want for p in per_step), f"launches per step {per_step}, expected {want}")

    check(traj.obs.shape == (PPO_STEPS, PPO_ENVS, env.agent_view_size**2), "trajectory obs shape")
    gen_replay = torch.Generator(device=device)
    gen_replay.set_state(snapshot)
    cache = env.batch_reset_cache(PPO_ENVS, resets_for(env, PPO_STEPS), gen_replay, device)
    noise = ar.draw_bits(gen_replay, (PPO_STEPS, env.num_actions, PPO_ENVS), device)
    weights = ar.repack_actor_params(model)
    for name in ("b1", "b2", "bh"):
        check(bool((getattr(weights, name) != 0).any()), f"bias {name} is still 0: the check would not see it")
    err, ties = ar.check_trajectory(
        env, weights, states0, cache, noise, final, traj._asdict(), ar.PLAIN_ATOL, TIE_MARGIN
    )
    phase(
        7,
        f"PPO {ENV_ID} {PPO_ENVS} envs x {PPO_STEPS} steps, hidden {PPO_HIDDEN}: {PPO_TRAIN_STEPS} train steps, "
        f"launches per step (actor, embed fwd, embed bwd) {per_step[0]}, last metrics "
        f"{ {k: float(v) for k, v in metrics.items()} }; actor kernel on step {PPO_TRAIN_STEPS} == plain "
        f"versions (logp/value max abs err {err}, {ties} near-ties of {PPO_STEPS * PPO_ENVS})",
    )

    # Times: the actor kernel alone against its plain version on the same
    # inputs, then train steps, rollout and update apart, through the
    # kernels and through the plain versions.
    k2 = partial(ar.fused_actor_rollout_core, env, weights, states0, cache, noise)
    p2 = partial(ar.actor_rollout_reference, env, weights, states0, cache, noise)
    tp1, tk1, tk2, tp2 = time_ms(p2, 1), time_ms(k2, 5), time_ms(k2, 5), time_ms(p2, 1)
    k2_ms, p2_ms = min(tk1, tk2), min(tp1, tp2)
    print(f"actor_rollout ({card}) {PPO_ENVS}x{PPO_STEPS}: kernel {k2_ms:.4f} ms, plain {p2_ms:.4f} ms", flush=True)

    steps = PPO_ENVS * PPO_STEPS
    for label, kernels, reps in (("plain", False, 2), ("kernels", True, 3), ("kernels", True, 3), ("plain", False, 2)):
        _, step_fn = make_ppo(env, config, hidden=PPO_HIDDEN, _plain=not kernels)
        holder = {}

        def roll():
            holder["roll"] = step_fn.rollout(state.params, state.env_states, state.generator)

        def upd():
            final, traj = holder["roll"]
            step_fn.update(state.params, state.opt_state, final, traj)

        roll()
        upd()
        torch.cuda.synchronize()
        r_ms, u_ms = [], []
        for _ in range(reps):
            r_ms.append(event_ms(roll))
            u_ms.append(event_ms(upd))
        r, u = statistics.median(r_ms), statistics.median(u_ms)
        print(
            f"ppo_env_steps_per_sec ({card}) {ENV_ID} {PPO_ENVS}x{PPO_STEPS} {label}: "
            f"{steps / (r + u) * 1e3:.6g} (train step {r + u:.4f} ms = rollout {r:.4f} ms + update {u:.4f} ms; "
            f"median of {reps} warm steps)",
            flush=True,
        )

    actor_entry = {
        "name": "actor_rollout",
        "route": "cuda",
        "source": "minigrid_tpu_torch/ops/csrc/actor_rollout.cu",
        "replaces": "minigrid_tpu/ops/actor_rollout.py:164",
        "launches": launches_k2,
        "max_abs_err": err,
        "ms": k2_ms,
        "plain_ms": p2_ms,
    }
    return actor_entry, launches_k3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    device = torch.device("cuda", 0)
    # The plain versions' float32 products in full float32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    phase(1, f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(_build.load_library, KERNELS))
    built = []
    for name in KERNELS:
        if name not in _build.BUILD_INFO:
            built.append(f"{name} already built")
            continue
        seconds, log = _build.BUILD_INFO[name]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spilled = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        built.append(
            f"{name} built in {seconds:.1f} s ({len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spilled} bytes spilled)"
        )
    phase(2, f"kernels loaded after {time.perf_counter() - t0:.1f} s; " + "; ".join(built))

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
    rollout_entry = {
        "name": "fused_rollout",
        "route": "cuda",
        "source": "minigrid_tpu_torch/ops/csrc/fused_rollout.cu",
        "replaces": "minigrid_tpu/ops/fused_rollout.py:335",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }

    embed_entries = embed_dense_check(device, card)
    actor_entry, launches_k3 = ppo_slice(device, card)
    embed_entries[0]["launches"] = launches_k3["fwd"]
    embed_entries[1]["launches"] = launches_k3["bwd"]
    summary = {"kernels": [rollout_entry, actor_entry, *embed_entries]}
    print(json.dumps(summary), flush=True)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_info}), flush=True)


if __name__ == "__main__":
    main()
