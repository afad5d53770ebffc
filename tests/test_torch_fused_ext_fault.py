"""The JAX package's ``uniform_index`` fault, which the port does not copy:
Dynamic-Obstacles-16x16's balls on the corner wall in JAX's reset, inside
the walls in the port's (``tests/test_torch_fused_ext.py``'s helpers; a
file of its own because JAX compiles the 16x16 reset for most of a minute
among the suite's workers)."""

from __future__ import annotations

import numpy as np
import torch

import minigrid_tpu as mg
import minigrid_tpu_torch as mgt
from minigrid_tpu.envs.dynamicobstacles import BALL_CELL
from test_torch_fused_ext import _jax_reset_states, _seeds


def test_reference_fault_puts_balls_on_the_corner_wall_and_the_port_does_not():
    # Dynamic-Obstacles-16x16 places 8 balls among 195 free cells: the JAX
    # package's int32 uniform_index wraps, nth_true_index falls back to
    # cell 0, and balls land on the wall at (0, 0).
    env_id = "MiniGrid-Dynamic-Obstacles-16x16-v0"
    jenv, tenv = mg.make(env_id), mgt.make(env_id)
    seeds, eps = _seeds(200, 4)
    ball = int(BALL_CELL)
    jgrid = np.asarray(_jax_reset_states(jenv, seeds, eps).grid)
    assert (jgrid[:, 0, 0] == ball).sum() > 100
    st = tenv.fused_ext.reset_block(tenv, torch.from_numpy(seeds), torch.from_numpy(eps))
    grid = st.grid.numpy()
    assert not (grid[:, 0, 0] == ball).any()
    assert ((grid == ball).sum(axis=(1, 2)) == tenv.n_obstacles).all()
    assert (grid[:, 1:-1, 1:-1] == ball).sum() == 200 * tenv.n_obstacles  # all inside the walls
    obst = st.extra["obstacles"].numpy()
    for i in range(tenv.n_obstacles):
        assert (grid[np.arange(200), obst[:, i, 0], obst[:, i, 1]] == ball).all()
