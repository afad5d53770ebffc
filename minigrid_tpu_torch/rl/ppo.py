"""PPO learner over the batched environment.

Counterpart of ``minigrid_tpu/rl/ppo.py``: collect ``rollout_steps`` on-policy
steps of every env, compute GAE, and take one clipped-surrogate update over
minibatches that are contiguous time slices of the trajectory.  Gradients
are clipped by global norm and applied by Adam, both written as optax's
``clip_by_global_norm`` and ``adam`` compute them.

On a CUDA device the collection runs in the whole-collection actor kernel
(ops/actor_rollout.py) and every first layer of the update, the minibatch
losses and the bootstrap value alike, runs through the fused embed +
dense-1 kernels (ops/embed_dense.py); a configuration the kernels do not
take raises.  On a CPU device the same calls run their plain PyTorch
versions.

With a ``mesh`` (``parallel/mesh.Mesh``, one process per device), every
rank collects and updates its shard of the envs through the same kernels,
and the update reduces over the ranks what the JAX package's partitioner
reduces: each minibatch's advantage mean and standard deviation (two
all-reduces of a [num_minibatches] vector an update), the gradients (one
all-reduce of a flat buffer a minibatch, before the global-norm clip) and
the metrics (one all-reduce, and ``LearnerResets``' two).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from minigrid_tpu_torch.parallel.mesh import (
    all_reduce,
    all_reduce_mean,
    local_count,
    rank_generator,
    replicate,
)
from minigrid_tpu_torch.rl.model import ActorCritic, apply_packed_fused
from minigrid_tpu_torch.rl.rollout import LearnerResets, collect_trajectory


class PPOConfig(NamedTuple):
    rollout_steps: int = 128
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    learning_rate: float = 2.5e-4
    max_grad_norm: float = 0.5
    # Pre-generated levels per env per rollout chunk, fixed; None sizes the
    # cache from parallel/reset_budget.learner_resets and grows it from the
    # chunks' episodes (rl/rollout.LearnerResets).  The metrics report each
    # chunk's R (``resets_per_chunk``) and the resets past it (``replayed``).
    resets_per_chunk: int | None = None
    # Gradient minibatches per update (time slices) and epochs over the rollout.
    num_minibatches: int = 8
    update_epochs: int = 1
    # Linear learning-rate anneal to 0 over this many train_step calls
    # (None: constant).
    lr_anneal_updates: int | None = None


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: ActorCritic
    opt_state: AdamState
    env_states: Any
    generator: torch.Generator


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


def adam_init(model: ActorCritic) -> AdamState:
    zeros = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def apply_gradients(model: ActorCritic, grads: dict[str, torch.Tensor], state: AdamState, lr: float, max_grad_norm: float) -> AdamState:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=1e-5))``
    applied to ``model``'s parameters in place; returns the new state.

    Clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` always).
    """
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    clip = norm >= max_grad_norm
    count = state.count + 1
    # optax takes the bias corrections' powers in float32.
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=norm.device) for b in (ADAM_B1, ADAM_B2))
    correct1, correct2 = 1 - b1**count, 1 - b2**count
    mu, nu = {}, {}
    for name, p in model.named_parameters():
        g = torch.where(clip, grads[name] / norm * max_grad_norm, grads[name])
        mu[name] = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[name]
        nu[name] = (1 - ADAM_B2) * g * g + ADAM_B2 * state.nu[name]
        p.add_(-lr * (mu[name] / correct1 / (torch.sqrt(nu[name] / correct2) + ADAM_EPS)))
    return AdamState(count, mu, nu)


def init_train_state(env, hidden: int, generator: torch.Generator, num_envs: int, mesh=None) -> TrainState:
    """``num_envs`` fresh envs, a fresh network and its Adam state, on the
    generator's device.

    With a ``mesh``, ``num_envs`` counts every rank's envs: the network is
    drawn from ``generator`` and rank 0's copy broadcast
    (``mesh.replicate``), then this rank's ``num_envs / W`` envs are reset
    from its rank generator, which the state keeps."""
    if mesh is None:
        device = generator.device
        _, env_states = env.reset(num_envs, generator, device)
        model = ActorCritic(hidden, env.num_actions, env.agent_view_size, generator, device)
        return TrainState(model, adam_init(model), env_states, generator)
    if generator.device != mesh.device:
        raise ValueError(f"the generator is on {generator.device}, the mesh's device is {mesh.device}")
    n = local_count(mesh, num_envs)
    model = replicate(mesh, ActorCritic(hidden, env.num_actions, env.agent_view_size, generator, mesh.device))
    gen = rank_generator(generator, mesh.rank, mesh.device)
    _, env_states = env.reset(n, gen, mesh.device)
    return TrainState(model, adam_init(model), env_states, gen)


def advantage_stats(adv: torch.Tensor, num_minibatches: int, mesh=None):
    """Each minibatch's advantage mean and population standard deviation
    (``adv`` [T, N], minibatches the contiguous time slices): the sum over
    the count, then the sum of squared deviations over the count, as XLA's
    ``mean`` and ``std``.  With a mesh both sums run over every rank's envs,
    one all-reduce of a [num_minibatches] vector each."""
    rows = adv.reshape(num_minibatches, -1)
    count = rows.shape[1] * (1 if mesh is None else mesh.world_size)
    sums = rows.sum(dim=1)
    if mesh is not None:
        all_reduce(mesh, sums)
    mean = sums / count
    squares = torch.square(rows - mean[:, None]).sum(dim=1)
    if mesh is not None:
        all_reduce(mesh, squares)
    return mean, torch.sqrt(squares / count)


def update_apply(model: ActorCritic, plain: bool):
    """The forward a learner's update uses: through the embed + dense-1
    kernels (on a CPU tensor that op is the plain version), or with
    ``plain`` the model's own forward."""
    if plain:
        return lambda obs, direction: model(obs, direction, packed=True)
    return lambda obs, direction: apply_packed_fused(model, obs, direction)


def bootstrap_observation(env, env_states, plain: bool) -> torch.Tensor:
    """The packed observation after a collection, which an update
    bootstraps its values from: through the observation kernel on a CUDA
    device, or with ``plain`` (the plain timing reference) its plain
    version."""
    return env.observation_packed(env_states, plain=plain)


def reduce_gradients(grads, mesh):
    """The gradients averaged over the ranks (one all-reduce), or as they
    are without a mesh."""
    return grads if mesh is None else all_reduce_mean(mesh, grads)


def reduce_learner_metrics(metrics: dict, mesh) -> dict:
    """A learner's metrics over every rank, in one float64 all-reduce: the
    loss and reward means averaged (every rank averages over as many
    samples), ``episodes`` summed; each keeps its dtype.  ``LearnerResets``
    has reduced its own."""
    if mesh is None:
        return metrics
    means, names = 4, ("pg_loss", "value_loss", "entropy", "reward_per_step", "episodes")
    buf = all_reduce(mesh, torch.stack([metrics[k].double() for k in names]))
    buf[:means] /= mesh.world_size
    return {**metrics, **{k: buf[i].to(metrics[k].dtype) for i, k in enumerate(names)}}


def make_ppo(env, config: PPOConfig = PPOConfig(), hidden: int = 256, mesh=None, *, _plain: bool = False):
    """Build ``(init_fn, train_step)`` for the given env family.

    ``init_fn(generator, num_envs) -> TrainState`` resets ``num_envs`` envs
    and initialises the network on the generator's device;
    ``train_step(state) -> (TrainState, metrics)`` collects and updates.
    ``train_step.rollout``, ``.update`` and ``.gae`` are its phases, and
    ``.loss_fn(apply, batch)`` its minibatch loss; ``train_step.resets`` is
    the ``LearnerResets`` that sizes each chunk's reset cache.  The parameters are
    updated in place.  ``_plain=True`` is a timing reference, not a
    learner option: it runs the plain versions on a CUDA device too, which
    ``chip_smoke.py`` times the kernels against.

    With a ``mesh`` (``parallel/mesh.make_mesh``), ``init_fn(generator,
    num_envs)`` takes the global env count and every rank's state holds its
    shard; ``train_step`` runs on each rank and reduces over the ranks (see
    the module's docstring), so the ranks' parameters stay equal.
    """
    resets = LearnerResets(env, config.rollout_steps, config.resets_per_chunk)
    steps_per_update = config.num_minibatches * config.update_epochs

    def learning_rate(count: int) -> float:
        # optax.linear_schedule(lr, 0, lr_anneal_updates * steps_per_update).
        if config.lr_anneal_updates is None:
            return config.learning_rate
        frac = min(count, config.lr_anneal_updates * steps_per_update) / (
            config.lr_anneal_updates * steps_per_update
        )
        return config.learning_rate * (1.0 - frac)

    def init_fn(generator: torch.Generator, num_envs: int) -> TrainState:
        return init_train_state(env, hidden, generator, num_envs, mesh)

    def rollout(model: ActorCritic, env_states, generator):
        return collect_trajectory(
            env, model, env_states, generator, config.rollout_steps, resets.r,
            fused_actor=not _plain, mesh=mesh, plain_obs=_plain,
        )

    def gae(values, rewards, dones, last_value):
        """adv_t = delta_t + gamma * lambda * nonterm_t * adv_{t+1}, as a
        reverse recurrence over T."""
        nonterm = 1.0 - dones.float()
        next_values = torch.cat([values[1:], last_value[None]], dim=0)
        delta = rewards + config.gamma * next_values * nonterm - values
        coef = config.gamma * config.gae_lambda * nonterm
        advs = torch.empty_like(values)
        adv = torch.zeros_like(last_value)
        for t in range(values.shape[0] - 1, -1, -1):
            adv = delta[t] + coef[t] * adv
            advs[t] = adv
        return advs

    def loss_fn(apply, batch, adv_stats=None):
        """The minibatch loss; ``adv_stats`` is the (mean, std) its
        advantages are normalised with, where None those of ``batch``."""
        obs, direction, action, old_logp, adv, target = batch
        logits, value = apply(obs, direction)
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, action.long()[..., None])[..., 0]
        ratio = torch.exp(logp - old_logp)
        adv_mean, adv_std = (s[0] for s in advantage_stats(adv, 1)) if adv_stats is None else adv_stats
        adv_n = (adv - adv_mean) / (adv_std + 1e-8)
        pg = -torch.minimum(
            ratio * adv_n, torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv_n
        ).mean()
        v_loss = 0.5 * torch.square(value - target).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        loss = pg + config.value_coef * v_loss - config.entropy_coef * entropy
        return loss, (pg, v_loss, entropy)

    def update(model: ActorCritic, opt_state: AdamState, env_states, traj):
        """GAE and the minibatched clipped-surrogate update on a collected
        trajectory; returns (model, opt_state, metrics)."""
        obs, direction, action, logp, value, reward, done = traj
        apply = update_apply(model, _plain)
        with torch.no_grad():
            _, last_value = apply(bootstrap_observation(env, env_states, _plain), env_states.agent_dir)
            adv = gae(value, reward, done, last_value)
        target = adv + value
        num_steps = obs.shape[0]
        if num_steps % config.num_minibatches != 0:
            raise ValueError(
                f"rollout_steps={num_steps} must divide into num_minibatches="
                f"{config.num_minibatches} (time-axis slicing)"
            )
        mb_t = num_steps // config.num_minibatches
        adv_mean, adv_std = advantage_stats(adv, config.num_minibatches, mesh)
        data = (obs, direction, action, logp, adv, target)
        names, params = zip(*model.named_parameters())
        auxes = []
        for _ in range(config.update_epochs):
            for b in range(config.num_minibatches):
                batch = tuple(x[b * mb_t : (b + 1) * mb_t] for x in data)
                loss, aux = loss_fn(apply, batch, (adv_mean[b], adv_std[b]))
                grads = reduce_gradients(torch.autograd.grad(loss, params), mesh)
                opt_state = apply_gradients(
                    model, dict(zip(names, grads)), opt_state,
                    learning_rate(opt_state.count), config.max_grad_norm,
                )
                auxes.append(torch.stack([a.detach() for a in aux]))
        pg, v_loss, entropy = torch.stack(auxes).mean(dim=0)
        metrics = {
            "pg_loss": pg,
            "value_loss": v_loss,
            "entropy": entropy,
            "reward_per_step": reward.mean(),
            "episodes": done.sum(),
            # Reset-budget certification (parallel/reset_budget): the most
            # episodes any env finished this chunk, the chunk's R and the
            # resets past it, which replayed the cache's last level (0 for
            # a family that cannot replay one); R grows for the next chunk
            # when the chunk comes near it.
            **resets.observe(done, mesh),
        }
        return model, opt_state, reduce_learner_metrics(metrics, mesh)

    def train_step(state: TrainState):
        env_states, traj = rollout(state.params, state.env_states, state.generator)
        model, opt_state, metrics = update(state.params, state.opt_state, env_states, traj)
        return TrainState(model, opt_state, env_states, state.generator), metrics

    train_step.rollout = rollout
    train_step.update = update
    train_step.resets = resets
    train_step.gae = gae
    train_step.loss_fn = loss_fn
    return init_fn, train_step


def make_train(env, config: PPOConfig = PPOConfig(), hidden: int = 256):
    """``train(generator, num_envs, num_updates) -> (TrainState, metrics)``:
    ``num_updates`` train steps, with each metric stacked over them."""
    init_fn, train_step = make_ppo(env, config, hidden=hidden)

    def train(generator: torch.Generator, num_envs: int, num_updates: int):
        state = init_fn(generator, num_envs)
        history = []
        for _ in range(num_updates):
            state, metrics = train_step(state)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history]) for k in history[0]}

    return train
