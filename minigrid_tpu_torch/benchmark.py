"""Per-env benchmark CLI (reference: minigrid/benchmark.py:13-132).

Counterpart of ``minigrid_tpu/benchmark.py``.  Measures, for one env id:
  * reset latency (ms/reset of one env, host-visible, including the device
    sync at the end),
  * world-render FPS (full-grid RGB frames),
  * agent-view FPS (partial-obs RGB frames, the reference's step proxy),
  * batched env-steps/s: ``rollout_random`` of ``num_envs`` envs for
    ``num_steps`` steps, through the whole-rollout kernel on the card.

Everything runs on ``device``, the card unless the caller passes
``device="cpu"``; every timed window on the card ends with
``torch.cuda.synchronize()``.  The first rollout builds the kernel and
warms up (the JAX package's compile call); the second is timed.  On the
card an id whose rollout would not take the kernel
(``parallel/vector.fused_eligible``) raises; on the CPU every step is the
plain batched ``step_env``.

Usage::

    python -m minigrid_tpu_torch.benchmark --env-id MiniGrid-Empty-8x8-v0
"""

from __future__ import annotations

import argparse
import time

import torch

from minigrid_tpu_torch.core.state import resolve_device
from minigrid_tpu_torch.parallel.vector import fused_eligible, rollout_random
from minigrid_tpu_torch.registry import make


def benchmark(
    env_id: str,
    num_resets: int = 200,
    num_frames: int = 200,
    tile_size: int = 32,
    num_envs: int = 4096,
    num_steps: int = 128,
    device=None,
) -> dict:
    device = resolve_device(None, device)
    env = make(env_id)
    on_card = device.type == "cuda"
    if on_card and not fused_eligible(env, device):
        raise ValueError(f"{env_id}: rollout_random would not take the whole-rollout kernel on {device}")
    generator = torch.Generator(device=device).manual_seed(0)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def per_second(fn, calls: int) -> float:
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        return calls / (time.perf_counter() - t0)

    # -- reset latency (a fresh draw from the generator each call) --
    _, state = env.reset(1, generator)
    reset_ms = 1e3 / per_second(lambda: env.reset(1, generator), num_resets)

    # -- world render FPS --
    env.get_frame(state, highlight=True, tile_size=tile_size)
    world_fps = per_second(lambda: env.get_frame(state, highlight=True, tile_size=tile_size), num_frames)

    # -- agent-view FPS (render POV each step like the reference's
    #    RGBImgPartialObsWrapper loop, minigrid/benchmark.py:31-43) --
    env.get_frame(state, tile_size=tile_size, agent_pov=True)
    pov_fps = per_second(lambda: env.get_frame(state, tile_size=tile_size, agent_pov=True), num_frames)

    # -- batched step throughput --
    _, states = env.reset(num_envs, generator)
    states, _, _, _ = rollout_random(env, states, generator, num_steps)  # builds the kernel, warms up
    rollouts = per_second(lambda: rollout_random(env, states, generator, num_steps), 1)

    return {
        "env_id": env_id,
        "reset_ms": reset_ms,
        "world_render_fps": world_fps,
        "agent_view_fps": pov_fps,
        "env_steps_per_sec": num_envs * num_steps * rollouts,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env-id", default="MiniGrid-LavaGapS7-v0")
    p.add_argument("--num-resets", type=int, default=200)
    p.add_argument("--num-frames", type=int, default=200)
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--device", default=None, help="torch device to run on (default: CUDA)")
    args = p.parse_args(argv)
    r = benchmark(
        args.env_id,
        num_resets=args.num_resets,
        num_frames=args.num_frames,
        tile_size=args.tile_size,
        num_envs=args.num_envs,
        num_steps=args.num_steps,
        device=args.device,
    )
    print(f"env_id: {r['env_id']}")
    print(f"reset time: {r['reset_ms']:.2f} ms")
    print(f"world render FPS: {r['world_render_fps']:.0f}")
    print(f"agent view FPS: {r['agent_view_fps']:.0f}")
    print(f"batched env-steps/s ({args.num_envs} envs): {r['env_steps_per_sec']:.0f}")
    return r


if __name__ == "__main__":
    main()
