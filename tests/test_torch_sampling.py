"""The port's grid masks, placement sampling and chunked generation.

The masks of ``core/grid.py`` are held to the JAX package's, env by env,
with bounds that differ per env.  The sampling rules of ``core/sampling.py``
are exact where the rule is (the rectangle, the agent's cell, ``reject``,
an all-False mask) and statistical where the draw is: frequencies within
5 standard errors of uniform.  ``utils/chunked.py`` is held to its own
contract: chunks add up to the whole, in order."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import minigrid_tpu_torch as mgt
from minigrid_tpu.core import grid as jgrid
from minigrid_tpu.core import sampling as jsampling
from minigrid_tpu_torch.core import grid as g
from minigrid_tpu_torch.core import sampling as s
from minigrid_tpu_torch.core.constants import EMPTY_CELL, WALL_CELL
from minigrid_tpu_torch.core.state import FIELDS
from minigrid_tpu_torch.utils import chunked as ch

W, H = 9, 7


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _assert_uniform(counts, n_draws):
    """Counts over k equally likely outcomes within 5 standard errors."""
    k = len(counts)
    p = 1.0 / k
    sigma = np.sqrt(n_draws * p * (1 - p))
    assert np.all(np.abs(np.asarray(counts) - n_draws * p) <= 5 * sigma), counts


def test_masks_match_jax_with_per_env_bounds():
    rng = np.random.default_rng(0)
    n = 64
    x0, y0 = rng.integers(0, 4, n), rng.integers(0, 3, n)
    w, h = rng.integers(1, 6, n), rng.integers(1, 5, n)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    got = {
        "rect": g.rect_mask(W, H, t(x0), t(y0), t(w), t(h)),
        "horz": g.horz_wall_mask(W, H, t(x0), t(y0)),
        "horz_len": g.horz_wall_mask(W, H, t(x0), t(y0), t(w)),
        "vert": g.vert_wall_mask(W, H, t(x0), t(y0)),
        "vert_len": g.vert_wall_mask(W, H, t(x0), t(y0), t(h)),
    }
    for i in range(n):
        want = {
            "rect": jgrid.rect_mask(W, H, int(x0[i]), int(y0[i]), int(w[i]), int(h[i])),
            "horz": jgrid.horz_wall_mask(W, H, int(x0[i]), int(y0[i])),
            "horz_len": jgrid.horz_wall_mask(W, H, int(x0[i]), int(y0[i]), int(w[i])),
            "vert": jgrid.vert_wall_mask(W, H, int(x0[i]), int(y0[i])),
            "vert_len": jgrid.vert_wall_mask(W, H, int(x0[i]), int(y0[i]), int(h[i])),
        }
        for k, v in want.items():
            np.testing.assert_array_equal(got[k][i].numpy(), np.asarray(v), err_msg=f"{k} env {i}")
    # Shared bounds give one [W, H] mask, as in the JAX package.
    np.testing.assert_array_equal(g.rect_mask(W, H, 1, 2, 3, 4).numpy(), np.asarray(jgrid.rect_mask(W, H, 1, 2, 3, 4)))
    xs, ys = g.coord_grids(W, H)
    jxs, jys = jgrid.coord_grids(W, H)
    np.testing.assert_array_equal(np.broadcast_to(xs.numpy(), (W, H)), np.asarray(jxs))
    np.testing.assert_array_equal(np.broadcast_to(ys.numpy(), (W, H)), np.asarray(jys))
    grid = g.empty_grid(n, W, H, "cpu")
    out = g.put(grid, got["rect"], t(rng.integers(2, 9, n)))
    assert torch.equal(out != EMPTY_CELL, got["rect"])


def test_neighbor_mask_matches_jax():
    pos = torch.tensor([[0, 0], [4, 3], [8, 6], [2, 5]], dtype=torch.int32)
    for radius in (1, 2):
        got = s.neighbor_mask(W, H, pos, radius)
        for i, p in enumerate(pos.tolist()):
            want = jsampling.neighbor_mask(W, H, jnp.asarray(p), radius)
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_randint_takes_per_env_bounds_and_is_uniform():
    n = 60000
    low = torch.tensor([0, 2, 5], dtype=torch.int32).repeat(n // 3)
    high = torch.tensor([3, 7, 6], dtype=torch.int32).repeat(n // 3)
    x = s.randint(_gen(1), n, low, high)
    assert x.dtype == torch.int32 and bool(((x >= low) & (x < high)).all())
    for j, (lo, hi) in enumerate(((0, 3), (2, 7), (5, 6))):
        _assert_uniform(np.bincount(x[j::3].numpy() - lo, minlength=hi - lo), n // 3)
    # Shared int bounds, and an empty range draws ``low`` as JAX's does.
    y = s.randint(_gen(2), n, 1, 5)
    _assert_uniform(np.bincount(y.numpy() - 1, minlength=4), n)
    assert bool((s.randint(_gen(3), 16, 4, 4) == 4).all())
    assert bool((s.randint(_gen(3), 16, 4, torch.full((16,), 2, dtype=torch.int32)) == 4).all())
    d = s.rand_dir(_gen(4), n)
    _assert_uniform(np.bincount(d.numpy(), minlength=4), n)


def test_masked_uniform_index_rules():
    mask = torch.zeros((4, 10), dtype=torch.bool)
    mask[1, 7] = True
    mask[2, [0, 9]] = True
    mask[3] = True
    idx = s.masked_uniform_index(_gen(5), mask)
    assert idx[0] == 0  # all-False: index 0, as in JAX
    assert idx[1] == 7  # one set entry
    assert int(idx[2]) in (0, 9) and 0 <= int(idx[3]) < 10
    # Uniform over the set entries of each row.
    n = 30000
    m = torch.zeros((n, 12), dtype=torch.bool)
    m[:, [1, 4, 5, 10]] = True
    got = s.masked_uniform_index(_gen(6), m).numpy()
    assert set(np.unique(got)) == {1, 4, 5, 10}
    _assert_uniform(np.bincount(got, minlength=12)[[1, 4, 5, 10]], n)


def test_place_obj_pos_rules():
    n = 4000
    grid = g.wall_rect(g.empty_grid(n, W, H, "cpu"), 0, 0, W, H)
    grid = g.set_cell(grid, 3, 3, WALL_CELL)
    agent = torch.tensor([2, 2], dtype=torch.int32).expand(n, 2)
    top = (torch.full((n,), 1, dtype=torch.int32), 1)
    size = (torch.tensor([3, 5], dtype=torch.int32).repeat(n // 2), 4)  # per-env widths
    reject = torch.zeros((n, W, H), dtype=torch.bool)
    reject[:, 1, 1] = True
    pos = s.place_obj_pos(_gen(7), grid, agent_pos=agent, top=top, size=size, reject=reject)
    x, y = pos[:, 0], pos[:, 1]
    assert pos.dtype == torch.int32
    assert bool(((x >= 1) & (x < 1 + size[0]) & (y >= 1) & (y < 5)).all())  # the rectangle
    assert not bool(((x == 2) & (y == 2)).any())  # the agent's cell
    assert not bool(((x == 1) & (y == 1)).any())  # reject
    assert not bool(((x == 3) & (y == 3)).any())  # not empty
    # Free cells of the narrow rectangle: 3 x 4 less the agent's, the
    # rejected and the wall cell.
    lin = (x * H + y)[0::2].numpy()
    assert len(np.unique(lin)) == 9
    _assert_uniform(np.unique(lin, return_counts=True)[1], n // 2)
    # No free cell: (0, 0), as the JAX package gives.
    full = torch.full((3, W, H), WALL_CELL, dtype=torch.int32)
    assert s.place_obj_pos(_gen(8), full).tolist() == [[0, 0]] * 3
    # A negative top is clamped to 0, as in JAX.
    pos = s.place_obj_pos(_gen(9), grid, top=(-2, -2), size=(3, 3))
    assert bool(((pos >= 1) & (pos < 3)).all())


def test_chunked_generation_adds_up_in_order(monkeypatch):
    assert ch.lane_cap(361) == (ch.CELL_LANE_BUDGET // 361) // 1024 * 1024
    assert ch.lane_cap(10**9) == 1024
    seen = []

    def generate(count):
        seen.append(count)
        env = mgt.make("MiniGrid-GoToDoor-5x5-v0")
        return env._generate(count, _gen(len(seen)), "cpu")

    out = ch.chunked(generate, 2500, 1024)
    assert seen == [1024, 1024, 452]
    assert out.grid.shape == (2500, 5, 5) and out.extra["target_pos"].shape == (2500, 2)
    for f in FIELDS:
        assert getattr(out, f).shape[0] == 2500, f
    # The first chunk's levels come first.
    first = mgt.make("MiniGrid-GoToDoor-5x5-v0")._generate(1024, _gen(1), "cpu")
    assert torch.equal(out.grid[:1024], first.grid)
    assert torch.equal(out.extra["target_pos"][:1024], first.extra["target_pos"])
    # The reset cache goes through it: a small budget gives several chunks
    # and the same shapes.
    monkeypatch.setattr(ch, "CELL_LANE_BUDGET", 1024 * 19 * 19)
    env = mgt.make("MiniGrid-FourRooms-v0")
    cache = env.batch_reset_cache(600, 4, _gen(3))
    assert cache.grid.shape == (600, 4, 19, 19) and cache.mission.shape == (600, 4, 8)
    assert bool(((cache.grid & 0xFF) == 8).sum(dim=(2, 3)).eq(1).all())  # one goal per level
