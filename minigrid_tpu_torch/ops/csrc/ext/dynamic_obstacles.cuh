// Dynamic-Obstacles: the obstacle walk before every action, the >= 3 ->
// left action remap, the collision penalty, and the counter-reset level
// (minigrid_tpu_torch/envs/dynamicobstacles.py; the JAX package's
// minigrid_tpu/envs/dynamicobstacles.py::_DynamicObstaclesFusedExt).
//
// 2n + 3 extra scalars: ox0, oy0, ..., ox(n-1), oy(n-1),
// front_not_clear, walk_seed0, walk_seed1.  In registers they sit in
// fixed slots of MAX_OBSTACLES, each loop unrolled and guarded by n, so no
// slot is indexed at run time.  Per step the walk reads the 3x3
// neighbourhood of every ball (9n gathered loads) and draws n/2 threefry
// pairs; a reset writes the W*H scaffold and scans the grid twice per
// placement.  `reset` is the per-lane form (the actor kernel),
// `warp_reset` the whole-warp form (the random-policy kernel), whose lanes
// write and scan 1/32 of the cells each.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

// "obst", "walk": the walk seed of an episode is threefry(e, WALK_TAG).
constexpr uint32_t WALK_TAG0 = 0x6F627374u;
constexpr uint32_t WALK_TAG1 = 0x77616C6Bu;

struct DynamicObstaclesExt : NoExt {
  static constexpr bool PRE_STEP = true;
  static constexpr bool COUNTER_RESET = true;
  static constexpr bool WARP_RESET = true;
  // Its reset writes neither contents nor mission.
  static constexpr int SWITCHES[3] = {1, 1, SWITCH_ANY};
  static constexpr int MAX_K = 2 * MAX_OBSTACLES + 3;

  struct Extra {
    int ox[MAX_OBSTACLES], oy[MAX_OBSTACLES];
    int front_not_clear;
    uint32_t ws0, ws1;
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams& p) {
    const int* col = scal + n;
    const int k = p.n_obstacles;
    Extra x;
#pragma unroll
    for (int i = 0; i < MAX_OBSTACLES; ++i) {
      x.ox[i] = i < k ? col[(size_t)(2 * i) * N] : 0;
      x.oy[i] = i < k ? col[(size_t)(2 * i + 1) * N] : 0;
    }
    x.front_not_clear = col[(size_t)(2 * k) * N];
    x.ws0 = (uint32_t)col[(size_t)(2 * k + 1) * N];
    x.ws1 = (uint32_t)col[(size_t)(2 * k + 2) * N];
    return x;
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams& p, const Extra& x) {
    int* col = scal + n;
    const int k = p.n_obstacles;
#pragma unroll
    for (int i = 0; i < MAX_OBSTACLES; ++i) {
      if (i < k) {
        col[(size_t)(2 * i) * N] = x.ox[i];
        col[(size_t)(2 * i + 1) * N] = x.oy[i];
      }
    }
    col[(size_t)(2 * k) * N] = x.front_not_clear;
    col[(size_t)(2 * k + 1) * N] = (int)x.ws0;
    col[(size_t)(2 * k + 2) * N] = (int)x.ws1;
  }

  __device__ static int map_action(int action) { return action >= 3 ? ACT_LEFT : action; }

  // The front cell is read before the balls move; then each ball, in index
  // order, moves to the uniform_index-th free cell of its 3x3
  // neighbourhood in linear order (x outer, y inner), free meaning empty
  // and not the agent's cell on the grid as the balls before it left it.
  // Balls 2j and 2j+1 take the two words of threefry(walk_seed, (step, j)).
  __device__ static void pre_step(const ExtParams& p, int* grid, uint8_t*, size_t N, int W, int H,
                                  const Scalars& s, Extra& x) {
    const int dx = (s.d == 0) - (s.d == 2);
    const int dy = (s.d == 1) - (s.d == 3);
    const int fx = min(max(s.ax + dx, 0), W - 1);
    const int fy = min(max(s.ay + dy, 0), H - 1);
    const int ft = grid[(size_t)(fx * H + fy) * N] & 0xFF;
    x.front_not_clear = ft != OBJ_EMPTY && ft != OBJ_GOAL;
    const int agent = s.ax * H + s.ay;
    Words pair{0u, 0u};
#pragma unroll
    for (int i = 0; i < MAX_OBSTACLES; ++i) {
      if (i < p.n_obstacles) {
        if ((i & 1) == 0) pair = threefry2x32(x.ws0, x.ws1, (uint32_t)s.step, (uint32_t)(i >> 1));
        const uint32_t bits = (i & 1) ? pair.w1 : pair.w0;
        const int ox = x.ox[i], oy = x.oy[i];
        int free_mask = 0, count = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int cx = ox - 1 + a, cy = oy - 1 + b;
            const int lin = cx * H + cy;
            const bool free = cx >= 0 && cx < W && cy >= 0 && cy < H && lin != agent &&
                              (grid[(size_t)lin * N] & 0xFF) == OBJ_EMPTY;
            free_mask |= (int)free << (3 * a + b);
            count += free;
          }
        }
        int nx = ox, ny = oy;
        if (count > 0) {
          int target = uniform_index(bits, count);
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            if ((free_mask >> k) & 1) {
              if (target == 0) {
                nx = ox - 1 + k / 3;
                ny = oy - 1 + k % 3;
              }
              --target;
            }
          }
        }
        grid[(size_t)(ox * H + oy) * N] = EMPTY_CELL;
        grid[(size_t)(nx * H + ny) * N] = BALL_CELL;
        x.ox[i] = nx;
        x.oy[i] = ny;
      }
    }
  }

  // Walking into a blocked cell other than the goal (read before the walk)
  // costs -1 and ends the episode; ctx.action is the unmapped action.
  __device__ static bool post_step(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const bool collided = ctx.action == ACT_FORWARD && x.front_not_clear;
    if (collided) reward = -1.0f;
    return collided;
  }

  // The scaffold; a random start draws the agent's cell and direction from
  // placement words 0 and 1; then ball i takes the next word and a uniform
  // empty cell that is not the agent's.
  __device__ static void reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s, Extra& x) {
    int* grid = rc.grid;
    const size_t N = rc.N;
    const int W = rc.W, H = rc.H;
    const int WH = W * H;
    walled_plane(grid, N, W, H);
    int word = 0, ax = p.start_x, ay = p.start_y, d = p.start_dir;
    if (p.start_x < 0) {
      const int lin = draw_free_cell(grid, N, WH, -1, place_word(e, 0));
      ax = lin / H;
      ay = lin % H;
      d = uniform_index(place_word(e, 1), 4);
      word = 2;
    }
    const int agent = ax * H + ay;
#pragma unroll
    for (int i = 0; i < MAX_OBSTACLES; ++i) {
      if (i < p.n_obstacles) {
        const int lin = draw_free_cell(grid, N, WH, agent, place_word(e, word + i));
        grid[(size_t)lin * N] = BALL_CELL;
        x.ox[i] = lin / H;
        x.oy[i] = lin % H;
      }
    }
    const Words ws = threefry2x32(e.w0, e.w1, WALK_TAG0, WALK_TAG1);
    x.front_not_clear = 0;
    x.ws0 = ws.w0;
    x.ws1 = ws.w1;
    s = fresh_scalars(ax, ay, d, p.max_steps);
  }

  // The same level, made by a whole warp on the env's grid row (stride 1).
  __device__ static void warp_reset(const ExtParams& p, const Words& e, const ResetCtx& rc, Scalars& s,
                                    Extra& x, int lane) {
    int* grid = rc.grid;
    const int W = rc.W, H = rc.H;
    const int WH = W * H;
    warp_walled_plane(grid, W, H, lane);
    __syncwarp();
    int word = 0, ax = p.start_x, ay = p.start_y, d = p.start_dir;
    if (p.start_x < 0) {
      const int lin = warp_draw_free_cell(grid, WH, -1, place_word(e, 0), lane);
      ax = lin / H;
      ay = lin % H;
      d = uniform_index(place_word(e, 1), 4);
      word = 2;
    }
    const int agent = ax * H + ay;
#pragma unroll
    for (int i = 0; i < MAX_OBSTACLES; ++i) {
      if (i < p.n_obstacles) {
        const int lin = warp_draw_free_cell(grid, WH, agent, place_word(e, word + i), lane);
        if (lane == 0) grid[lin] = BALL_CELL;
        __syncwarp();
        x.ox[i] = lin / H;
        x.oy[i] = lin % H;
      }
    }
    const Words ws = threefry2x32(e.w0, e.w1, WALK_TAG0, WALK_TAG1);
    x.front_not_clear = 0;
    x.ws0 = ws.w0;
    x.ws1 = ws.w1;
    s = fresh_scalars(ax, ay, d, p.max_steps);
  }
};

}  // namespace minigrid
