"""What data-parallel training sends between devices: the bytes of its
collectives a train step, and the efficiency a link rate would allow.

Counterpart of the accounting half of ``minigrid_tpu/parallel/scaling.py``
(``param_bytes``, ``modeled_ppo_efficiency``).  ``expected_collectives``
takes the place of ``hlo_collectives``: the JAX package reads the
collectives XLA's partitioner inserted from the compiled program, while the
port issues its own through ``parallel/mesh``, which logs each one
(``mesh.COLLECTIVES``), so the list a train step should log is written down
here from the learners' code and tests hold the log to it.  The JAX
module's timing of XLA's virtual CPU mesh (``pin_to_one_core``,
``efficiency_curve``, ``rollout_runner``) has no counterpart: a process per
device has no virtual mesh to time.
"""

from __future__ import annotations

import torch

from minigrid_tpu_torch.rl.ppo import PPOConfig

# NVIDIA's H100 SXM datasheet: 900 GB/s of NVLink bandwidth a GPU, both
# directions together, so 450e9 bytes/s a direction.  A datasheet figure,
# not a measurement; used only by the modelled efficiency.
NVLINK_BYTES_PER_SEC = 450e9

# Payload bytes of the learners' small all-reduces: LearnerResets' maximum
# (int64) and replayed count (int32), and the float64 metric vector (the
# four means and the episode count).
MOST_EPISODES_BYTES = 8
REPLAYED_BYTES = 4
METRIC_BYTES = 5 * 8


def param_bytes(model) -> int:
    """Bytes of the parameters of ``model`` (a module or a tree's tensors)."""
    params = model.parameters() if isinstance(model, torch.nn.Module) else model
    return sum(p.numel() * p.element_size() for p in params)


def gradient_bytes_per_step(model, config, world_size: int) -> float:
    """Bytes each device sends (and receives) for the gradient all-reduces
    of one train step on a ring of ``world_size`` devices: 2(W-1)/W of the
    parameters' bytes, once a minibatch of every epoch."""
    steps = config.num_minibatches * config.update_epochs
    return 2.0 * (world_size - 1) / world_size * param_bytes(model) * steps


def modeled_ppo_efficiency(
    t_step_seconds: float,
    model,
    num_minibatches: int,
    update_epochs: int,
    n_devices: int,
    link_bytes_per_sec: float = NVLINK_BYTES_PER_SEC,
) -> float:
    """Data-parallel PPO efficiency on an ``n_devices`` ring, modelled: the
    measured train step of one device's shard, ``t_step_seconds``, over that
    step plus the ring all-reduce time of its gradients at
    ``link_bytes_per_sec``; the rest is parallel and the statistics' few
    bytes are left out (the JAX package's ``modeled_ppo_efficiency``)."""
    config = PPOConfig(num_minibatches=num_minibatches, update_epochs=update_epochs)
    coll = gradient_bytes_per_step(model, config, n_devices)
    return t_step_seconds / (t_step_seconds + coll / link_bytes_per_sec)


def expected_collectives(model, config, learner: str = "ppo") -> list[tuple[str, int]]:
    """The ``(op, bytes)`` entries one train step of ``learner`` ("ppo" or
    "impala") logs on a mesh, in order; the same at every world size.  PPO
    first sums the minibatches' advantages and squared deviations (a
    float32 [num_minibatches] vector each); then both learners all-reduce
    the gradients once a minibatch, ``LearnerResets`` takes its maximum and
    sums its replayed count, and the metrics are reduced together."""
    if learner not in ("ppo", "impala"):
        raise ValueError(f"unknown learner {learner!r}")
    stats = [("all_reduce(sum)", 4 * config.num_minibatches)] * 2 if learner == "ppo" else []
    grads = [("all_reduce(sum)", param_bytes(model))] * (config.num_minibatches * config.update_epochs)
    resets = [("all_reduce(max)", MOST_EPISODES_BYTES), ("all_reduce(sum)", REPLAYED_BYTES)]
    return stats + grads + resets + [("all_reduce(sum)", METRIC_BYTES)]
