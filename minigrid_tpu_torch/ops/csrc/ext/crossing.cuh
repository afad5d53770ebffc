// Crossing mazes: identity step hooks and the counter-reset level
// (minigrid_tpu_torch/envs/crossing.py::_CrossingResetExt; the JAX
// package's minigrid_tpu/envs/crossing.py:152-290), draw for draw:
// placement words 0..kc-1 choose the rivers, kc..2kc-1 the path moves,
// 2kc..3kc-1 the openings.  The room-limit tables are indexed by the room
// the path has reached, so they live in local memory; a reset writes the
// W*H scaffold and then at most kc*(max(W, H)-2) river and kc opening cells.
// `reset` is the per-lane form (the actor kernel), `warp_reset` the
// whole-warp form (the random-policy kernel), which writes each cell once.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct CrossingExt : NoExt {
  static constexpr bool COUNTER_RESET = true;
  static constexpr bool WARP_RESET = true;
  // Its reset writes neither contents nor mission.
  static constexpr int SWITCHES[3] = {1, 1, SWITCH_ANY};

  __device__ static void reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s, Extra&) {
    int* grid = rc.grid;
    const size_t N = rc.N;
    const int W = rc.W, H = rc.H;
    const int kc = p.num_crossings;
    constexpr int BIG = 1000000;
    // Candidates: vertical rivers at x in {2, 4, ... < H-2}, then
    // horizontal ones at y in {2, 4, ... < W-2}.
    const int nv_cand = H > 3 ? (H - 3) / 2 : 0;
    const int n_cand = nv_cand + (W > 3 ? (W - 3) / 2 : 0);

    // Ordered sample of kc distinct candidates.
    uint32_t chosen = 0;
    int pos[MAX_CROSSINGS], is_v[MAX_CROSSINGS];
    int n_v = 0;
    for (int t = 0; t < kc; ++t) {
      int r = uniform_index(place_word(e, t), n_cand - t);
      int j = 0;
      for (int c = 0; c < n_cand; ++c) {
        if (!((chosen >> c) & 1u)) {
          if (r == 0) {
            j = c;
            break;
          }
          --r;
        }
      }
      chosen |= 1u << j;
      is_v[t] = j < nv_cand;
      pos[t] = 2 + 2 * (is_v[t] ? j : j - nv_cand);
      n_v += is_v[t];
    }

    // Room limits [0] + sorted river positions + [edge].
    int lv[MAX_CROSSINGS + 2], lh[MAX_CROSSINGS + 2];
    int rv[MAX_CROSSINGS], rh[MAX_CROSSINGS];
    for (int t = 0; t < kc; ++t) {
      int v = is_v[t] ? pos[t] : BIG, h = is_v[t] ? BIG : pos[t];
      int i = t;
      for (; i > 0 && rv[i - 1] > v; --i) rv[i] = rv[i - 1];
      rv[i] = v;
      i = t;
      for (; i > 0 && rh[i - 1] > h; --i) rh[i] = rh[i - 1];
      rh[i] = h;
    }
    lv[0] = lh[0] = 0;
    for (int i = 1; i <= kc; ++i) {
      lv[i] = i <= n_v ? rv[i - 1] : H - 1;
      lh[i] = i <= kc - n_v ? rh[i - 1] : W - 1;
    }
    lv[kc + 1] = H - 1;
    lh[kc + 1] = W - 1;

    // The scaffold, then the rivers.
    walled_plane(grid, N, W, H);
    for (int t = 0; t < kc; ++t) {
      if (is_v[t]) {
        for (int y = 1; y <= H - 2; ++y) grid[(size_t)(pos[t] * H + y) * N] = p.obstacle_cell;
      } else {
        for (int x = 1; x <= W - 2; ++x) grid[(size_t)(x * H + pos[t]) * N] = p.obstacle_cell;
      }
    }

    // The path: n_v horizontal moves among kc, each opening one cell of the
    // river it crosses.
    int remaining_h = n_v, ri = 0, rj = 0;
    for (int t = 0; t < kc; ++t) {
      const bool hmove = uniform_index(place_word(e, kc + t), kc - t) < remaining_h;
      remaining_h -= hmove;
      const uint32_t bits = place_word(e, 2 * kc + t);
      int x, y;
      if (hmove) {
        const int lo = lh[rj] + 1, hi = lh[rj + 1];
        x = lv[ri + 1];
        y = lo + uniform_index(bits, max(hi - lo, 1));
      } else {
        const int lo = lv[ri] + 1, hi = lv[ri + 1];
        x = lo + uniform_index(bits, max(hi - lo, 1));
        y = lh[rj + 1];
      }
      grid[(size_t)(x * H + y) * N] = EMPTY_CELL;
      ri += hmove;
      rj += !hmove;
    }
    s = fresh_scalars(p.start_x, p.start_y, p.start_dir, p.max_steps);
  }

  // The rivers (position, vertical or not) and the path's openings of a
  // level: reset's draws, in its order.  reset computes them inline as it
  // writes, and keeps the actor kernel's per-lane body (and its code) as
  // it is.
  struct Plan {
    int pos[MAX_CROSSINGS], open_x[MAX_CROSSINGS], open_y[MAX_CROSSINGS];
    bool is_v[MAX_CROSSINGS];
  };

  __device__ static Plan plan(const ExtParams& p, const Words& e, int W, int H) {
    const int kc = p.num_crossings;
    constexpr int BIG = 1000000;
    const int nv_cand = H > 3 ? (H - 3) / 2 : 0;
    const int n_cand = nv_cand + (W > 3 ? (W - 3) / 2 : 0);
    Plan l;
    uint32_t chosen = 0;
    int n_v = 0;
    for (int t = 0; t < kc; ++t) {
      int r = uniform_index(place_word(e, t), n_cand - t);
      int j = 0;
      for (int c = 0; c < n_cand; ++c) {
        if (!((chosen >> c) & 1u)) {
          if (r == 0) {
            j = c;
            break;
          }
          --r;
        }
      }
      chosen |= 1u << j;
      l.is_v[t] = j < nv_cand;
      l.pos[t] = 2 + 2 * (l.is_v[t] ? j : j - nv_cand);
      n_v += l.is_v[t];
    }
    int lv[MAX_CROSSINGS + 2], lh[MAX_CROSSINGS + 2];
    int rv[MAX_CROSSINGS], rh[MAX_CROSSINGS];
    for (int t = 0; t < kc; ++t) {
      int v = l.is_v[t] ? l.pos[t] : BIG, h = l.is_v[t] ? BIG : l.pos[t];
      int i = t;
      for (; i > 0 && rv[i - 1] > v; --i) rv[i] = rv[i - 1];
      rv[i] = v;
      i = t;
      for (; i > 0 && rh[i - 1] > h; --i) rh[i] = rh[i - 1];
      rh[i] = h;
    }
    lv[0] = lh[0] = 0;
    for (int i = 1; i <= kc; ++i) {
      lv[i] = i <= n_v ? rv[i - 1] : H - 1;
      lh[i] = i <= kc - n_v ? rh[i - 1] : W - 1;
    }
    lv[kc + 1] = H - 1;
    lh[kc + 1] = W - 1;
    int remaining_h = n_v, ri = 0, rj = 0;
    for (int t = 0; t < kc; ++t) {
      const bool hmove = uniform_index(place_word(e, kc + t), kc - t) < remaining_h;
      remaining_h -= hmove;
      const uint32_t bits = place_word(e, 2 * kc + t);
      if (hmove) {
        const int lo = lh[rj] + 1, hi = lh[rj + 1];
        l.open_x[t] = lv[ri + 1];
        l.open_y[t] = lo + uniform_index(bits, max(hi - lo, 1));
      } else {
        const int lo = lv[ri] + 1, hi = lv[ri + 1];
        l.open_x[t] = lo + uniform_index(bits, max(hi - lo, 1));
        l.open_y[t] = lh[rj + 1];
      }
      ri += hmove;
      rj += !hmove;
    }
    return l;
  }

  // The same level, made by a whole warp on the env's grid row (stride 1):
  // each lane plans it, the lanes write the scaffold with the rivers over
  // it (reset's order: walls, goal, rivers), then lane t opens cell t.
  __device__ static void warp_reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s,
                                    Extra&, int lane) {
    int* grid = rc.grid;
    const int W = rc.W, H = rc.H;
    const int kc = p.num_crossings;
    const Plan l = plan(p, e, W, H);
    const int goal = (W - 2) * H + H - 2;
    for (int k = lane; k < W * H; k += 32) {
      const int x = k / H, y = k - (k / H) * H;
      bool river = false;
      for (int t = 0; t < kc; ++t) {
        river |= l.is_v[t] ? x == l.pos[t] && y >= 1 && y <= H - 2 : y == l.pos[t] && x >= 1 && x <= W - 2;
      }
      const bool border = x == 0 || y == 0 || x == W - 1 || y == H - 1;
      grid[k] = river ? p.obstacle_cell : k == goal ? GOAL_CELL : border ? WALL_CELL : EMPTY_CELL;
    }
    __syncwarp();
    for (int t = 0; t < kc; ++t) {
      if (lane == t) grid[l.open_x[t] * H + l.open_y[t]] = EMPTY_CELL;
    }
    s = fresh_scalars(p.start_x, p.start_y, p.start_dir, p.max_steps);
  }
};

}  // namespace minigrid
