"""Whole-collection actor kernel: the policy inside the environment loop.

Port of ``minigrid_tpu/ops/actor_rollout.py``.  The kernel
(``csrc/actor_rollout.cu``, CUDA C++ for Hopper) replaces the Pallas kernel
``_actor_kernel``: for T steps every env observes (the packed view), runs
the actor MLP on its one-hot features, samples its action by Gumbel-argmax
from injected random bits, steps through the family's hooks and
auto-resets, from an R-slot reset cache (``core/env.step_cached``
semantics; a cached ext's extra scalars come from the same slot) or, for a
counter-reset family (random-start Empty, Crossing, Dynamic-Obstacles, or
one written outside the package with its own header), by regenerating a
fresh level in the kernel from per-env seeds
(``FusedExt.reset_block``).  Only the trajectory leaves the
kernel.

The actor's arithmetic is the TPU kernel's, which differs from
``rl/model.ActorCritic`` in where it rounds: layer 1 adds an f32 bias to the
f32 sum, applies ReLU and then rounds to bf16; layer 2 likewise; the heads
take bf16 weights with an f32 bias.  ``actor_policy_reference`` is that
arithmetic in plain PyTorch.

``fused_actor_rollout_core`` dispatches on the device of the state: CUDA
tensors launch the kernel (or raise), CPU tensors run
``actor_rollout_reference``.  ``KERNEL_LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from minigrid_tpu_torch.core.state import FIELDS, EnvState, select, tree_leaves
from minigrid_tpu_torch.ops.fused_rollout import (
    check_env_and_state,
    check_ext,
    counter_reset,
    ext_buffers,
    fresh_episodes,
    from_env_minor,
    kernel_flags,
    kernel_library,
    to_env_minor,
    view_refusal,
    with_extra,
)
from minigrid_tpu_torch.ops.prng import draw_seeds
from minigrid_tpu_torch.parallel.vector import MAX_FUSED_CELLS, fused_eligible

# Hidden widths the kernel takes: multiples of HIDDEN_MULTIPLE up to
# MAX_HIDDEN.  The built-in library holds PPO's 256 and the tests' 64 at
# view 7; another width or view is built at its first launch
# (``fused_rollout.kernel_library``).
HIDDEN_MULTIPLE = 32
MAX_HIDDEN = 512
# Above this width layer 1 runs in two passes of hidden/4 columns a
# warpgroup (``csrc/actor_rollout.cu``'s ``Smem::PASSES``), and W1's tiles
# come a pass at a time.
ONE_PASS_HIDDEN = 256
# The kernel takes N that this divides: its blocks of 64 envs (one
# tensor-core M tile) mask the empty half of a last block.
NUM_ENVS_MULTIPLE = 32
# The most actions the kernel takes; its head rows (logits, value) are
# padded to MAX_ACTIONS + 1.
MAX_ACTIONS = 7
HEAD_ROWS = MAX_ACTIONS + 1
# Launches of the CUDA kernel since import (or since a caller reset it).
KERNEL_LAUNCHES = 0
# The row block of ``actor_policy_reference``'s products.
POLICY_ROWS = 2048
# The kernel's logp and value against ``actor_policy_reference``: both round
# at the same points; layer 1's f32 sums of bf16 rows are exact in any order,
# layer 2 is the same in-order float32 chain in both (the kernel's CUDA cores,
# the reference's product at its fixed block shape), and the heads' f32
# outputs differ by float rounding only; so they agree far inside the bf16
# tolerance (2e-2) that holds the port's actor to the JAX package's.
PLAIN_ATOL = 1e-4

_ARGTYPES = [ctypes.c_void_p] * 27 + [ctypes.c_int] * 26 + [ctypes.c_void_p]


class ActorWeights(NamedTuple):
    """The actor's weights in the kernel's layout (no TPU padding)."""

    w1: torch.Tensor  # bf16 [v*v*20 + 4, H]  (flax Dense_0 kernel)
    b1: torch.Tensor  # f32 [H]
    w2: torch.Tensor  # bf16 [H, H]  (flax Dense_1 kernel, [in, out])
    b2: torch.Tensor  # f32 [H]
    wh: torch.Tensor  # bf16 [A + 1, H]: the A logit rows, then the value row
    bh: torch.Tensor  # f32 [A + 1]


@torch.no_grad()
def repack_actor_params(model) -> ActorWeights:
    """``rl/model.ActorCritic`` parameters -> the kernel's weights."""
    bf16 = torch.bfloat16
    heads = torch.cat([model.Dense_2.kernel, model.Dense_3.kernel], dim=1)  # [H, A + 1]
    return ActorWeights(
        w1=model.Dense_0.kernel.to(bf16).contiguous(),
        b1=model.Dense_0.bias.float().contiguous(),
        w2=model.Dense_1.kernel.to(bf16).contiguous(),
        b2=model.Dense_1.bias.float().contiguous(),
        wh=heads.t().to(bf16).contiguous(),
        bh=torch.cat([model.Dense_2.bias, model.Dense_3.bias]).float().contiguous(),
    )


class ActorTiles(NamedTuple):
    """The kernel's matrices in its shared-memory layouts: the tensor cores'
    B layout (``csrc/hopper.cuh``: per K tile of 16 rows, [N/8][2][8][8]
    bf16) for layer 1 and the heads; W2 as it is, for layer 2 on the CUDA
    cores."""

    # W1 padded to ``onehot_words`` * 32 rows, as hi and lo (``split_w1``)
    # per K tile, a layer-1 pass's tiles after the pass before's: [passes *
    # words * 2, 2, H/passes/8, 2, 8, 8], a pass's columns each warpgroup's
    # share of it (``pass_columns``)
    w1: torch.Tensor
    w2: torch.Tensor  # W2 [H, H] bf16, row-major
    wh: torch.Tensor  # the head rows as B [H, 8] (zero past A + 1), [H/16, 1, 2, 8, 8]


def onehot_words(view_size: int) -> int:
    """32-row words of the one-hot features (V*V*20 + 4 rows, padded)."""
    return (view_size * view_size * 20 + 4 + 31) // 32


def tile_b(b: torch.Tensor) -> torch.Tensor:
    """[K, N] (K a multiple of 16, N of 8) in the B layout: element (k, n)
    at [k // 16, n // 8, (k % 16) // 8, n % 8, k % 8]."""
    k, n = b.shape
    return b.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 3, 1, 4, 2).contiguous()


def untile_b(t: torch.Tensor) -> torch.Tensor:
    """The [K, N] matrix of a tile in the B layout (``tile_b``'s inverse)."""
    kt, nt = t.shape[:2]
    return t.permute(0, 2, 4, 1, 3).reshape(kt * 16, nt * 8)


def layer1_passes(hidden: int) -> int:
    """Layer 1's passes over W1: one up to ``ONE_PASS_HIDDEN``, else two."""
    return 1 if hidden <= ONE_PASS_HIDDEN else 2


def pass_columns(hidden: int, index: int, device=None) -> torch.Tensor:
    """W1's columns in layer-1 pass ``index``, on ``device``: warpgroup 0's
    share of that pass (its columns hidden/2/passes * index onwards), then
    warpgroup 1's (the same from hidden/2).  One pass is every column in
    order."""
    np_ = hidden // 2 // layer1_passes(hidden)
    first = torch.arange(np_, device=device) + index * np_
    return torch.cat([first, first + hidden // 2])


def split_w1(w1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 W1 as hi + lo, both bf16 and exact: hi its bits from 2^-16 up
    (multiples of 2^-16), lo the rest (below 2^-16).  A sum of 148 hi values
    and one of 148 lo values are each exact in float32, so their float32 sum
    is the exact sum rounded once, in any order."""
    w = w1.float()
    hi = torch.trunc(w * 2.0**16) / 2.0**16
    return hi.to(torch.bfloat16), (w - hi).to(torch.bfloat16)


@torch.no_grad()
def tile_actor_weights(weights: ActorWeights, view_size: int) -> ActorTiles:
    """The kernel's tiled layout of ``weights``, made once per launch: W1's
    rows padded with zeros to whole one-hot words and split (``split_w1``),
    its columns a layer-1 pass at a time (``pass_columns``), the head rows
    padded to ``HEAD_ROWS``."""
    bf16 = torch.bfloat16
    f, hidden = weights.w1.shape
    w1 = torch.zeros((onehot_words(view_size) * 32, hidden), dtype=bf16, device=weights.w1.device)
    w1[:f] = weights.w1
    wh = torch.zeros((HEAD_ROWS, hidden), dtype=bf16, device=weights.wh.device)
    wh[: weights.wh.shape[0]] = weights.wh
    hi, lo = split_w1(w1)
    passes = []
    for index in range(layer1_passes(hidden)):
        # Made on the weights' device: a copy from the host would wait for
        # the card.
        cols = pass_columns(hidden, index, w1.device)
        passes.append(torch.stack([tile_b(hi[:, cols]), tile_b(lo[:, cols])], dim=1))
    return ActorTiles(torch.cat(passes).contiguous(), weights.w2.to(bf16).contiguous(), tile_b(wh.t()))


def draw_bits(generator: torch.Generator | None, shape, device) -> torch.Tensor:
    """Uniform int32 random bits (all 32 bits), the sampler's input."""
    return torch.randint(-(2**31), 2**31, shape, generator=generator, device=device, dtype=torch.int32)


def actor_policy_reference(weights: ActorWeights, packed: torch.Tensor, direction: torch.Tensor):
    """The kernel's actor in plain PyTorch: logits f32 [N, A], value f32 [N].

    Layer 1's pre-activation is the exact sum of the selected bf16 rows
    (float64, exact for them) rounded once to float32, which does not depend
    on the order of the sum.  Layer 2 is a float32 product; on the card its
    rows go in blocks of ``POLICY_ROWS`` (the last one padded), because the
    CUDA library picks the product's kernel, and with it the summation order,
    by shape, and another order can flip the bf16 rounding of h2: a fixed
    block shape keeps the reference's rounding the same for every N."""
    from minigrid_tpu_torch.rl.model import embed_obs_packed

    n = packed.shape[0]
    pad = -n % POLICY_ROWS if packed.is_cuda else 0
    if pad:
        packed = torch.cat([packed, packed.new_zeros((pad, packed.shape[1]))])
        direction = torch.cat([direction, direction.new_zeros(pad)])
    out = []
    rows = POLICY_ROWS if packed.is_cuda else max(n, 1)
    for pk, dr in zip(packed.split(rows), direction.split(rows)):
        x = embed_obs_packed(pk, dr)
        pre1 = (x.double() @ weights.w1.double()).float()  # the exact sum, rounded once
        h1 = torch.relu(pre1 + weights.b1).to(torch.bfloat16).float()
        h2 = torch.relu(h1 @ weights.w2.float() + weights.b2).to(torch.bfloat16).float()
        out.append(h2 @ weights.wh.float().t() + weights.bh)
    heads = torch.cat(out)[:n]
    return heads[:, :-1], heads[:, -1]


def sample_actions(logits: torch.Tensor, bits: torch.Tensor):
    """Gumbel-argmax over ``logits`` f32 [N, A] from ``bits`` int32 [A, N]
    (the construction behind ``jax.random.categorical``): u = (the top 24
    bits + 0.5) / 2^24, z = logits - log(-log u), the first maximum wins.
    Returns (action int32 [N], logp f32 [N])."""
    u = (((bits >> 8) & 0xFFFFFF).float() + 0.5) * (1.0 / (1 << 24))
    z = logits.t() + -torch.log(-torch.log(u))
    action = torch.argmax(z, dim=0)  # the first of equal maxima
    m = logits.max(dim=-1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
    logp = logits.gather(1, action[:, None])[:, 0] - lse
    return action.to(torch.int32), logp


def shape_refusal(env, num_envs: int, hidden: int) -> str | None:
    """Why the kernel does not take ``num_envs`` envs of ``env`` at this
    hidden size, or None: at most ``MAX_FUSED_CELLS`` grid cells, a multiple
    of ``NUM_ENVS_MULTIPLE`` envs, 1 to ``MAX_ACTIONS`` actions, an odd
    view from 3 to 31 and a hidden size that is a multiple of
    ``HIDDEN_MULTIPLE`` up to ``MAX_HIDDEN``."""
    cells = env.width * env.height
    if cells > MAX_FUSED_CELLS:
        return f"{cells} grid cells; the kernel takes at most {MAX_FUSED_CELLS}"
    if num_envs % NUM_ENVS_MULTIPLE != 0:
        return f"num_envs {num_envs} is not a multiple of {NUM_ENVS_MULTIPLE}"
    if not 1 <= env.num_actions <= MAX_ACTIONS:
        return f"{env.num_actions} actions; the kernel takes 1 to {MAX_ACTIONS}"
    view = view_refusal(env.agent_view_size)
    if view is not None:
        return view
    if hidden % HIDDEN_MULTIPLE != 0 or not HIDDEN_MULTIPLE <= hidden <= MAX_HIDDEN:
        return f"hidden size {hidden}; the kernel takes multiples of {HIDDEN_MULTIPLE} up to {MAX_HIDDEN}"
    return None


def supports_fused_actor(env, device, num_envs: int, hidden: int) -> bool:
    """Whether the kernel runs this configuration: what ``parallel/vector.
    fused_eligible`` asks of the random-policy kernel (a default-hook family
    or one with a compiled counter-reset or cached ext), and a shape it takes
    (``shape_refusal``)."""
    return fused_eligible(env, device) and shape_refusal(env, num_envs, hidden) is None


def fused_actor_rollout(env, model, states: EnvState, generator, num_steps: int, resets_per_chunk: int = 2):
    """Collect ``num_steps`` on-policy steps of ``model`` (an
    ``rl/model.ActorCritic``) with the actor in the kernel.

    Draws from ``generator`` the per-env reset seeds int32 [N, 2] (a
    counter-reset family, which ignores ``resets_per_chunk``) or the R-slot
    reset cache, and then the sampling bits [T, A, N], in the JAX package's
    order.  Returns ``(final_states, traj)`` with time-major [T, N] leaves:
    obs (int32 [T, N, v*v] packed), direction, action, logp, value, reward,
    done (bool), as ``rl/rollout.collect_trajectory``.
    """
    n, device = states.step_count.shape[0], states.device
    cache = seeds = None
    if counter_reset(env):
        seeds = draw_seeds(generator, n, device)
    else:
        cache = env.batch_reset_cache(n, resets_per_chunk, generator, device)
    noise = draw_bits(generator, (num_steps, env.num_actions, n), device)
    return fused_actor_rollout_core(env, repack_actor_params(model), states, cache, noise, seeds)


def fused_actor_rollout_core(
    env, weights: ActorWeights, states: EnvState, cache: EnvState | None, noise: torch.Tensor, reset_seeds=None
):
    """The collection over explicit sampling bits ``noise`` int32 [T, A, N]
    and reset ``cache`` (leaves [N, R, ...]) or, for a counter-reset family,
    ``cache=None`` and ``reset_seeds`` int32 [N, 2]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if states.device.type == "cpu":
        return actor_rollout_reference(env, weights, states, cache, noise, reset_seeds)
    return _launch(env, weights, states, cache, noise, reset_seeds)


def actor_rollout_reference(
    env, weights: ActorWeights, states: EnvState, cache: EnvState | None, noise: torch.Tensor, reset_seeds=None
):
    """Plain PyTorch version of the kernel, on any device: a loop over T of
    observe, the plain actor, sample, ``step_env`` (the family's hooks
    included) and the auto-reset (``fused_rollout.fresh_episodes``)."""
    check_ext(env, states, cache, "actor_rollout")
    used = torch.zeros(states.step_count.shape[0], dtype=torch.int32, device=states.device)
    out = {k: [] for k in ("obs", "direction", "action", "logp", "value", "reward", "done")}
    st = states
    for bits in noise:
        obs = env.observation_packed(st, plain=True)
        logits, value = actor_policy_reference(weights, obs, st.agent_dir)
        action, logp = sample_actions(logits, bits)
        stepped, reward = env.step_env(st, action)
        done = stepped.terminated | stepped.truncated
        for k, x in zip(out, (obs, st.agent_dir, action, logp, value, reward, done)):
            out[k].append(x)
        st = select(done, fresh_episodes(env, cache, reset_seeds, used), stepped)
        used = used + done.int()
    return st, {k: torch.stack(v) for k, v in out.items()}


@torch.no_grad()
def check_trajectory(
    env, weights: ActorWeights, states, cache, noise, final, traj, atol=2e-2, margin=1e-2, reset_seeds=None
):
    """Hold a trajectory collected from ``states`` with reset ``cache`` (or,
    for a counter-reset family, ``reset_seeds``) and sampling bits ``noise``
    [T, A, N] to the actor kernel's three contracts; raises AssertionError
    where one fails.

    1. Env replay: ``step_env`` on the trajectory's actions with the same
       auto-reset gives its obs, direction, reward (rtol 1e-6: XLA may
       contract the reward into an FMA) and done at every step, and
       ``final``, every field and ``extra`` leaf.
    2. Policy: ``actor_policy_reference`` on its obs gives its logp and value
       to ``atol`` (bf16 rounding).
    3. Sampling: ``sample_actions`` on its bits and the plain actor's logits
       gives its action wherever the top two Gumbel scores are more than
       ``margin`` apart, and at least 99% of positions are that far apart.

    Returns (max abs err of logp and value, positions within the margin).
    """

    def ensure(cond, message):
        if not cond:
            raise AssertionError(message)

    n = states.step_count.shape[0]
    used = torch.zeros(n, dtype=torch.int32, device=states.device)
    st = states
    err, ties = 0.0, 0
    for t, bits in enumerate(noise):
        obs, direction, action = traj["obs"][t], traj["direction"][t], traj["action"][t]
        ensure(torch.equal(env.observation_packed(st, plain=True), obs), f"obs differs at t={t}")
        ensure(torch.equal(st.agent_dir, direction), f"direction differs at t={t}")
        logits, value = actor_policy_reference(weights, obs, direction)
        logp = torch.log_softmax(logits, dim=-1).gather(1, action.long()[:, None])[:, 0]
        err = max(err, float((logp - traj["logp"][t]).abs().max()), float((value - traj["value"][t]).abs().max()))
        u = (((bits >> 8) & 0xFFFFFF).float() + 0.5) * (1.0 / (1 << 24))
        z = (logits.t() + -torch.log(-torch.log(u))).sort(dim=0, descending=True).values
        clear = (z[0] - z[1]) > margin
        sampled, _ = sample_actions(logits, bits)
        ensure(bool(((sampled == action) | ~clear).all()), f"sampled action differs at t={t}")
        ties += int((~clear).sum())
        stepped, reward = env.step_env(st, action)
        done = stepped.terminated | stepped.truncated
        ensure(torch.allclose(reward, traj["reward"][t], rtol=1e-6, atol=0), f"reward differs at t={t}")
        ensure(torch.equal(done, traj["done"][t]), f"done differs at t={t}")
        st = select(done, fresh_episodes(env, cache, reset_seeds, used), stepped)
        used = used + done.int()
    for f in FIELDS:
        ensure(torch.equal(getattr(st, f), getattr(final, f)), f"final state field {f} differs")
    ensure((st.extra is None) == (final.extra is None), "final extra on one side only")
    for (k, v), (_, got) in zip(tree_leaves(st.extra), tree_leaves(final.extra)):
        ensure(v.shape == got.shape and torch.equal(v, got), f"final extra {k} differs")
    ensure(err <= atol, f"logp/value differ from the plain actor by {err}")
    ensure(ties <= 0.01 * noise.shape[0] * n, f"{ties} near-ties: fewer than 99% of positions compared")
    return err, ties


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"actor_rollout kernel: {message}")


def _launch(env, weights: ActorWeights, states: EnvState, cache, noise: torch.Tensor, reset_seeds=None):
    global KERNEL_LAUNCHES
    r = check_env_and_state(env, states, cache, "actor_rollout")
    device = states.device
    n = states.step_count.shape[0]
    na = env.num_actions
    v2 = env.agent_view_size**2
    hidden = weights.w2.shape[0]
    refusal = shape_refusal(env, n, hidden)
    _require(refusal is None, refusal)
    t = noise.shape[0]
    _require(noise.shape == (t, na, n), f"noise must be [T, {na}, {n}], got {tuple(noise.shape)}")
    _require(noise.dtype == torch.int32 and noise.device == device, "noise must be int32 on the state's device")
    for name, x, shape, dtype in (
        ("w1", weights.w1, (v2 * 20 + 4, hidden), torch.bfloat16),
        ("b1", weights.b1, (hidden,), torch.float32),
        ("w2", weights.w2, (hidden, hidden), torch.bfloat16),
        ("b2", weights.b2, (hidden,), torch.float32),
        ("wh", weights.wh, (na + 1, hidden), torch.bfloat16),
        ("bh", weights.bh, (na + 1,), torch.float32),
    ):
        _require(tuple(x.shape) == shape, f"{name} must be {shape}, got {tuple(x.shape)}")
        _require(x.dtype == dtype and x.device == device, f"{name} must be {dtype} on {device}")
    ext = ext_buffers(env, states, cache, reset_seeds, "actor_rollout")

    grid, cont, sc, mis, cgrid, ccont, csc, cmis = to_env_minor(states, cache)
    tiles = tile_actor_weights(weights, env.agent_view_size)
    w = (tiles.w1, weights.b1.contiguous(), tiles.w2, weights.b2.contiguous(), tiles.wh, weights.bh.contiguous())
    bits = noise.contiguous()
    traj = {
        "obs": torch.empty((t, n, v2), dtype=torch.int32, device=device),
        "direction": torch.empty((t, n), dtype=torch.int32, device=device),
        "action": torch.empty((t, n), dtype=torch.int32, device=device),
        "logp": torch.empty((t, n), dtype=torch.float32, device=device),
        "value": torch.empty((t, n), dtype=torch.float32, device=device),
        "reward": torch.empty((t, n), dtype=torch.float32, device=device),
        "done": torch.empty((t, n), dtype=torch.bool, device=device),
    }

    lib = kernel_library("actor_rollout", env, hidden)
    _require(lib.actor_rollout_supports(env.agent_view_size, hidden) == 1, "the library holds no such shape")
    _require(lib.actor_rollout_words(env.agent_view_size) == onehot_words(env.agent_view_size), "one-hot words")
    fn = lib.actor_rollout_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(None if x is None else x.data_ptr() for x in (bits, grid, cont, sc, mis, cgrid, ccont, csc, cmis)),
            *ext.pointers(),
            *(x.data_ptr() for x in (*w, *traj.values())),
            env.width, env.height, env.agent_view_size, r, states.mission.shape[-1], t, n,
            0 if ext.scal is None else ext.scal.shape[0],
            0 if ext.planes is None else ext.planes.shape[0],
            na, hidden,
            *kernel_flags(env),
            ext.ext_id,
            *ext.params,
            *ext.user,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"actor_rollout kernel launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return with_extra(env, from_env_minor(states, grid, cont, sc, mis), ext), traj
