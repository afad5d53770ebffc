"""IMPALA learner: V-trace off-policy actor-critic over the batched environment.

Counterpart of ``minigrid_tpu/rl/impala.py``: collect ``rollout_steps``
on-policy steps of every env, then update over minibatches that are
contiguous time slices of the trajectory, each with V-trace targets
(Espeholt et al. 2018, arXiv:1802.01561) bootstrapped from the value of the
observation just after its slice: the next slice's first observation, or
the post-rollout observation for the last slice.  Off-policyness enters
through the later minibatches and epochs, whose parameters have moved
since the collection; V-trace's clipped importance weights correct for it.
Gradients are clipped by global norm and applied by Adam
(``rl/ppo.apply_gradients``).

The collection and every first layer of the update run where PPO's do
(``rl/ppo.py``): the actor kernel and the embed + dense-1 kernels on a CUDA
device, their plain versions on the CPU.  The bootstrap forward runs
without a graph, since no gradient flows through V-trace's targets, so the
embed + dense-1 backward runs once per minibatch.

With a ``mesh``, every rank runs the update on its shard of the envs.  The
V-trace recursion runs along each env's time axis and the loss is a mean
over samples, so, unlike PPO's advantage normalisation, nothing but the
gradients (one all-reduce a minibatch) and the metrics crosses ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from minigrid_tpu_torch.rl.ppo import (
    AdamState,
    TrainState,
    apply_gradients,
    bootstrap_observation,
    init_train_state,
    reduce_gradients,
    reduce_learner_metrics,
    update_apply,
)
from minigrid_tpu_torch.rl.rollout import LearnerResets, collect_trajectory


class IMPALAConfig(NamedTuple):
    rollout_steps: int = 128
    gamma: float = 0.99
    rho_clip: float = 1.0  # importance-weight clip of the V-trace deltas
    c_clip: float = 1.0  # trace-cutting clip
    vtrace_lambda: float = 1.0  # extra trace decay (lambda in the paper's c_t)
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    # None sizes the reset cache from parallel/reset_budget.learner_resets and
    # grows it; see PPOConfig.resets_per_chunk.
    resets_per_chunk: int | None = None
    num_minibatches: int = 8
    update_epochs: int = 1


@torch.no_grad()
def vtrace(
    target_logp: torch.Tensor,
    behavior_logp: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    rho_clip: float = 1.0,
    c_clip: float = 1.0,
    lam: float = 1.0,
):
    """V-trace targets and policy-gradient advantages (arXiv:1802.01561
    section 4.1), without a graph: no gradient flows through them.

    Inputs are time-major [T, ...]; ``bootstrap_value`` is V(x_T).  Returns
    (vs [T, ...], pg_adv [T, ...]):

        rho_t = min(rho_clip, e^(target - behavior))
        c_t = lam * min(c_clip, e^(target - behavior))
        delta_t = rho_t (r_t + gamma_t V(x_{t+1}) - V(x_t))
        vs_t - V_t = delta_t + gamma_t c_t (vs_{t+1} - V_{t+1})
        pg_adv_t = rho_t (r_t + gamma_t vs_{t+1} - V_t)

    The recurrence runs as a reverse loop over T.
    """
    rho_raw = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(rho_raw, max=rho_clip)
    c = lam * torch.clamp(rho_raw, max=c_clip)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    delta = rho * (rewards + discounts * next_values - values)
    err = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(values.shape[0] - 1, -1, -1):
        acc = delta[t] + discounts[t] * c[t] * acc
        err[t] = acc
    vs = values + err
    next_vs = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    return vs, rho * (rewards + discounts * next_vs - values)


def make_impala(env, config: IMPALAConfig = IMPALAConfig(), hidden: int = 256, mesh=None, *, _plain: bool = False):
    """Build ``(init_fn, train_step)`` for the given env family, with
    ``rl/ppo.make_ppo``'s contract: ``init_fn(generator, num_envs) ->
    TrainState``; ``train_step(state) -> (TrainState, metrics)``, with
    ``train_step.rollout`` and ``.update`` its phases and
    ``.loss_fn(apply, batch)`` its minibatch loss.  The parameters are
    updated in place.  ``_plain=True`` is ``chip_smoke.py``'s timing
    reference: the plain versions on a CUDA device too.  ``mesh`` as in
    ``make_ppo``.
    """
    resets = LearnerResets(env, config.rollout_steps, config.resets_per_chunk)

    def init_fn(generator: torch.Generator, num_envs: int) -> TrainState:
        return init_train_state(env, hidden, generator, num_envs, mesh)

    def rollout(model, env_states, generator):
        return collect_trajectory(
            env, model, env_states, generator, config.rollout_steps, resets.r,
            fused_actor=not _plain, mesh=mesh, plain_obs=_plain,
        )

    def loss_fn(apply, batch):
        obs, direction, action, behavior_logp, reward, done, boot_obs, boot_dir = batch
        logits, values = apply(obs, direction)
        with torch.no_grad():
            _, boot_value = apply(boot_obs, boot_dir)
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logp = logp_all.gather(-1, action.long()[..., None])[..., 0]
        discounts = config.gamma * (1.0 - done.float())
        vs, pg_adv = vtrace(
            target_logp, behavior_logp, values, boot_value, reward, discounts,
            config.rho_clip, config.c_clip, config.vtrace_lambda,
        )
        pg_loss = -(target_logp * pg_adv).mean()
        v_loss = 0.5 * torch.square(values - vs).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        loss = pg_loss + config.value_coef * v_loss - config.entropy_coef * entropy
        return loss, (pg_loss, v_loss, entropy)

    def update(model, opt_state: AdamState, env_states, traj):
        """The minibatched V-trace update on a collected trajectory; returns
        (model, opt_state, metrics)."""
        apply = update_apply(model, _plain)
        num_steps = traj.obs.shape[0]
        if num_steps % config.num_minibatches != 0:
            raise ValueError(
                f"rollout_steps={num_steps} must divide into num_minibatches="
                f"{config.num_minibatches} (time-axis slicing)"
            )
        mb_t = num_steps // config.num_minibatches
        last_obs = bootstrap_observation(env, env_states, _plain)
        data = (traj.obs, traj.direction, traj.action, traj.logp, traj.reward, traj.done)
        names, params = zip(*model.named_parameters())
        auxes = []
        for _ in range(config.update_epochs):
            for b in range(config.num_minibatches):
                end = (b + 1) * mb_t
                # The slice bootstraps from the observation just after it.
                boot = (traj.obs[end], traj.direction[end]) if end < num_steps else (last_obs, env_states.agent_dir)
                batch = tuple(x[b * mb_t : end] for x in data) + boot
                loss, aux = loss_fn(apply, batch)
                grads = reduce_gradients(torch.autograd.grad(loss, params), mesh)
                opt_state = apply_gradients(
                    model, dict(zip(names, grads)), opt_state, config.learning_rate, config.max_grad_norm
                )
                auxes.append(torch.stack([a.detach() for a in aux]))
        pg, v_loss, entropy = torch.stack(auxes).mean(dim=0)
        metrics = {
            "pg_loss": pg,
            "value_loss": v_loss,
            "entropy": entropy,
            "reward_per_step": traj.reward.mean(),
            "episodes": traj.done.sum(),
            # Reset-budget certification and R's growth, as in rl/ppo.py.
            **resets.observe(traj.done, mesh),
        }
        return model, opt_state, reduce_learner_metrics(metrics, mesh)

    def train_step(state: TrainState):
        env_states, traj = rollout(state.params, state.env_states, state.generator)
        model, opt_state, metrics = update(state.params, state.opt_state, env_states, traj)
        return TrainState(model, opt_state, env_states, state.generator), metrics

    train_step.rollout = rollout
    train_step.update = update
    train_step.resets = resets
    train_step.loss_fn = loss_fn
    return init_fn, train_step
