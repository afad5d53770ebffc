// Device functions shared by the kernels: the core transition, the
// auto-reset from an R-slot reset cache (fused_rollout.cu,
// actor_rollout.cu), the agent's view with its occlusion flood (those two
// and obs_packed.cu), and the rows of the learner's one-hot features
// (actor_rollout.cu, embed_dense.cu).
//
// The device functions take an env's cells as a pointer to its element 0
// and a stride, element k at [k * stride]: N for the actor kernel's
// env-minor [K, N] arrays (neighbouring threads touch neighbouring
// addresses for the scalar rows and gather their own cell of the grid
// planes), 1 for the random-policy kernel's env-major rows (an env's cells
// contiguous).  One thread owns one env.
//
// Bit-exactness with the JAX package: the reward is computed with
// round-to-nearest intrinsics, never contracted into an FMA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace minigrid {

constexpr int OBJ_EMPTY = 1;
constexpr int OBJ_WALL = 2;
constexpr int OBJ_FLOOR = 3;
constexpr int OBJ_DOOR = 4;
constexpr int OBJ_KEY = 5;
constexpr int OBJ_BALL = 6;
constexpr int OBJ_BOX = 7;
constexpr int OBJ_GOAL = 8;
constexpr int OBJ_LAVA = 9;
constexpr int NUM_OBJECTS = 11;
constexpr int NUM_COLORS = 6;
constexpr int STATE_OPEN = 0;
constexpr int STATE_LOCKED = 2;
constexpr int COLOR_GREY = 5;
constexpr int WALL_CELL = OBJ_WALL | (COLOR_GREY << 8);

constexpr int ACT_LEFT = 0;
constexpr int ACT_RIGHT = 1;
constexpr int ACT_FORWARD = 2;
constexpr int ACT_PICKUP = 3;
constexpr int ACT_DROP = 4;
constexpr int ACT_TOGGLE = 5;
constexpr int ACT_DONE = 6;

// Scalar-row order, as in the TPU kernel (minigrid_tpu/ops/fused_rollout.py:62).
enum { ROW_AX, ROW_AY, ROW_DIR, ROW_CARRY, ROW_STEP, ROW_MAX, ROW_TERM, ROW_TRUNC, NUM_SC };

// The eight scalar rows of one env, held in registers.
struct Scalars {
  int ax, ay, d, carry, step, max_steps, term, trunc;
};

// `sc` is the env's column of a [NUM_SC, N] array.
__device__ __forceinline__ Scalars load_scalars(const int* sc, size_t N) {
  return Scalars{sc[ROW_AX * N],   sc[ROW_AY * N],  sc[ROW_DIR * N],  sc[ROW_CARRY * N],
                 sc[ROW_STEP * N], sc[ROW_MAX * N], sc[ROW_TERM * N], sc[ROW_TRUNC * N]};
}

__device__ __forceinline__ void store_scalars(int* sc, size_t N, const Scalars& s) {
  sc[ROW_AX * N] = s.ax;
  sc[ROW_AY * N] = s.ay;
  sc[ROW_DIR * N] = s.d;
  sc[ROW_CARRY * N] = s.carry;
  sc[ROW_STEP * N] = s.step;
  sc[ROW_MAX * N] = s.max_steps;
  sc[ROW_TERM * N] = s.term;
  sc[ROW_TRUNC * N] = s.trunc;
}

__device__ __forceinline__ bool can_overlap(int t, int s) {
  return t == OBJ_EMPTY || t == OBJ_FLOOR || t == OBJ_GOAL || t == OBJ_LAVA ||
         (t == OBJ_DOOR && s == STATE_OPEN);
}

__device__ __forceinline__ bool can_pickup(int t) {
  return t == OBJ_KEY || t == OBJ_BALL || t == OBJ_BOX;
}

__device__ __forceinline__ bool see_behind(int cell) {
  const int t = cell & 0xFF;
  const int s = (cell >> 16) & 0xFF;
  return !(t == OBJ_WALL || (t == OBJ_DOOR && s != STATE_OPEN));
}

// One core transition (_step_block, minigrid_tpu/ops/fused_rollout.py:98-206)
// of the env whose grid and contents columns are `grid`, `cont`: turn,
// forward, pickup, drop, toggle, then reward, termination and truncation
// (overwritten every step, not accumulated).  Returns the reward.
// The cell in front of the agent, clamped into the grid: the only cell a
// core step can write.
struct Cell {
  int x, y;
};

__device__ __forceinline__ Cell front_cell(const Scalars& s, int W, int H) {
  const int dx = (s.d == 0) - (s.d == 2);
  const int dy = (s.d == 1) - (s.d == 3);
  return Cell{min(max(s.ax + dx, 0), W - 1), min(max(s.ay + dy, 0), H - 1)};
}

// The reference's success reward 1 - 0.9 * step / max_steps on post-step
// scalars, each operation rounded to nearest as core/step.success_reward
// rounds it (never contracted into an FMA).
__device__ __forceinline__ float success_reward(const Scalars& s) {
  return __fsub_rn(1.0f, __fmul_rn(0.9f, __fdiv_rn((float)s.step, (float)s.max_steps)));
}

template <bool NO_OBJECTS>
__device__ __forceinline__ float core_step(int* grid, int* cont, size_t N, int W, int H,
                                           Scalars& s, int action) {
  const Cell f = front_cell(s, W, H);
  const int fx = f.x, fy = f.y;
  s.step += 1;
  const size_t fidx = (size_t)(fx * H + fy) * N;
  const int fcell = grid[fidx];
  const int ftype = fcell & 0xFF;
  const int fcolor = (fcell >> 8) & 0xFF;
  const int fstate = (fcell >> 16) & 0xFF;

  if (action == ACT_LEFT) s.d = (s.d + 3) & 3;
  if (action == ACT_RIGHT) s.d = (s.d + 1) & 3;
  const bool is_fwd = action == ACT_FORWARD;
  if (is_fwd && can_overlap(ftype, fstate)) {
    s.ax = fx;
    s.ay = fy;
  }
  const bool hit_goal = is_fwd && ftype == OBJ_GOAL;
  const bool terminated = hit_goal || (is_fwd && ftype == OBJ_LAVA);
  float reward = 0.0f;
  if (hit_goal) reward = success_reward(s);

  if (!NO_OBJECTS) {
    const int fcont = cont[fidx];
    const bool hands_free = s.carry == 0;
    const bool do_pickup = action == ACT_PICKUP && can_pickup(ftype) && hands_free;
    const bool do_drop = action == ACT_DROP && ftype == OBJ_EMPTY && !hands_free;
    const bool has_key = (s.carry & 0xFF) == OBJ_KEY && ((s.carry >> 8) & 0xFF) == fcolor;
    const int door_state = fstate == STATE_LOCKED ? (has_key ? STATE_OPEN : STATE_LOCKED)
                                                  : (fstate == STATE_OPEN ? 1 : 0);
    const bool toggle_door = action == ACT_TOGGLE && ftype == OBJ_DOOR;
    const bool toggle_box = action == ACT_TOGGLE && ftype == OBJ_BOX;
    // The four branches are mutually exclusive.
    if (do_pickup) {
      grid[fidx] = OBJ_EMPTY;
      cont[fidx] = 0;
      s.carry = ftype | (fcolor << 8) | (fcont << 16);
    } else if (do_drop) {
      grid[fidx] = s.carry & 0xFFFF;
      cont[fidx] = (s.carry >> 16) & 0xFFFF;
      s.carry = 0;
    } else if (toggle_door) {
      grid[fidx] = (fcell & 0xFFFF) | (door_state << 16);
    } else if (toggle_box) {
      grid[fidx] = fcont == 0 ? OBJ_EMPTY : fcont;
      cont[fidx] = 0;
    }
  }
  s.term = terminated;
  s.trunc = s.step >= s.max_steps;
  return reward;
}

// The R-slot reset cache of the env in column n: [R, W*H, N] grid and
// contents planes, [R, NUM_SC, N] scalar rows, [R, M, N] mission, the
// family ext's K extra scalars [R, K, N] (none where K is 0) and its P
// extra byte planes [R, P, W*H, N] (none where P is 0).
struct Cache {
  const int* grid;
  const int* cont;
  const int* sc;
  const int* mis;
  const int* scal;
  const uint8_t* planes;
  int R, K, P;
};

// Auto-reset (minigrid_tpu/ops/fused_rollout.py:445-479): the ended episode
// is replaced by cache slot min(used, R-1), taken with the pre-increment
// `used`, the ext's extra scalars included (its Ext::load reads them from
// the slot's [K, N] plane into `x`) and its extra planes copied into the
// env's column `planes` of the live [P, W*H, N] planes.  One branch per
// ended episode; the cost does not depend on R.
template <class Ext, bool NO_OBJECTS, bool STATIC_MISSION, class Params>
__device__ __forceinline__ void cache_reset(const Cache& c, const Params& p, int n, int used, int* grid,
                                            int* cont, int* mis, uint8_t* planes, size_t N, int WH, int M,
                                            Scalars& s, typename Ext::Extra& x) {
  const int slot = min(used, c.R - 1);
  const int* cg = c.grid + (size_t)slot * WH * N + n;
  for (int k = 0; k < WH; ++k) grid[(size_t)k * N] = cg[(size_t)k * N];
  if (!NO_OBJECTS) {
    const int* cc = c.cont + (size_t)slot * WH * N + n;
    for (int k = 0; k < WH; ++k) cont[(size_t)k * N] = cc[(size_t)k * N];
  }
  s = load_scalars(c.sc + (size_t)slot * NUM_SC * N + n, N);
  if (!STATIC_MISSION) {
    const int* cm = c.mis + (size_t)slot * M * N + n;
    for (int k = 0; k < M; ++k) mis[(size_t)k * N] = cm[(size_t)k * N];
  }
  if constexpr (Ext::MAX_K > 0) x = Ext::load(c.scal + (size_t)slot * c.K * N, n, N, p);
  if constexpr (Ext::NUM_PLANES > 0) {
    const uint8_t* cp = c.planes + (size_t)slot * Ext::NUM_PLANES * WH * N + n;
    for (int k = 0; k < Ext::NUM_PLANES * WH; ++k) planes[(size_t)k * N] = cp[(size_t)k * N];
  }
}

// The agent's frame: its cell, its facing vector f and r = (-f_y, f_x).
struct ViewFrame {
  int ax, ay, fx, fy, rx, ry;
};

__device__ __forceinline__ ViewFrame view_frame(int ax, int ay, int d) {
  const int fx = (d == 0) - (d == 2);
  const int fy = (d == 1) - (d == 3);
  return ViewFrame{ax, ay, fx, fy, -fy, fx};
}

// The packed grid cell under view cell (i, j) of a V x V view: world cell
// agent + f * (V-1-j) - r * (V/2 - i), a wall outside the grid.  `grid`
// points at the env's cell 0 and cell (x, y) lies at [(x * H + y) * stride]:
// stride N for the actor kernel's env-minor planes, 1 for an env-major
// [N, W*H] grid (the random-policy and observation kernels).
template <int V>
__device__ __forceinline__ int view_cell(const int* grid, size_t stride, int W, int H, const ViewFrame& f,
                                         int i, int j) {
  const int wx = f.ax + f.fx * (V - 1 - j) - f.rx * (V / 2 - i);
  const int wy = f.ay + f.fy * (V - 1 - j) - f.ry * (V / 2 - i);
  const bool inside = wx >= 0 && wx < W && wy >= 0 && wy < H;
  return inside ? grid[(size_t)(wx * H + wy) * stride] : WALL_CELL;
}

// The packed cells of the agent's V x V view (_view_bits_block), the
// carried object (or empty) at the agent cell; `grid` as in view_cell.
template <int V>
__device__ __forceinline__ void view_cells(const int* grid, size_t N, int W, int H,
                                           const Scalars& s, int view[V][V]) {
  const ViewFrame f = view_frame(s.ax, s.ay, s.d);
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (i == V / 2 && j == V - 1) {
        view[i][j] = s.carry != 0 ? (s.carry & 0xFFFF) : OBJ_EMPTY;
      } else {
        view[i][j] = view_cell<V>(grid, N, W, H, f, i, j);
      }
    }
  }
}

// One row of the bit-parallel occlusion flood (minigrid_tpu/core/obs.py:
// 108-154), rows taken from j = V-1 (the agent's) up to 0: bit i of `t` is
// whether view cell (i, j) lets light through, `up` the cells the row below
// lit in this row (1 << V/2, the agent cell, for row V-1).  Light floods
// right in closed carry form, left by V-1 single spreads, and lit
// transparent cells light the three cells above them, which go into `up`
// for the next row.  Returns the row's lit mask.
template <int V>
__device__ __forceinline__ int flood_row(int t, int& up) {
  constexpr int FULL = (1 << V) - 1;
  const int m_r = up | ((((up & t) + t) & FULL) ^ t);
  const int cond_r = m_r & t & ((1 << (V - 1)) - 1);
  const int new_up = cond_r | ((cond_r << 1) & FULL);
  int m_l = m_r;
#pragma unroll
  for (int k = 0; k < V - 1; ++k) m_l |= (m_l & t) >> 1;
  const int cond_l = m_l & t & ~1;
  up = new_up | cond_l | (cond_l >> 1);
  return m_l;
}

// Sets the cells the agent cannot see to 0 ("unseen"), as
// core/obs.gen_obs_packed does.
template <int V, bool SEE_THROUGH>
__device__ __forceinline__ void hide_unseen(int view[V][V]) {
  if (SEE_THROUGH) return;
  int up = 1 << (V / 2);
#pragma unroll
  for (int j = V - 1; j >= 0; --j) {
    int t = 0;
#pragma unroll
    for (int i = 0; i < V; ++i) t |= see_behind(view[i][j]) ? (1 << i) : 0;
    const int lit = flood_row<V>(t, up);
#pragma unroll
    for (int i = 0; i < V; ++i) view[i][j] = ((lit >> i) & 1) ? view[i][j] : 0;
  }
}

// Views wider than 7, whose V x V cells the rollout kernels do not hold in
// registers: the flood on 32-bit unsigned masks (flood_row's, exact up to
// V = 32 by wraparound; the kernels take up to 31), the value of one view
// cell, and the lit mask of every view row.

template <int V>
__device__ __forceinline__ uint32_t flood_row_u32(uint32_t t, uint32_t& up) {
  constexpr uint32_t FULL = V >= 32 ? 0xFFFFFFFFu : (1u << V) - 1u;
  const uint32_t m_r = up | ((((up & t) + t) & FULL) ^ t);
  const uint32_t cond_r = m_r & t & (FULL >> 1);
  const uint32_t new_up = cond_r | ((cond_r << 1) & FULL);
  uint32_t m_l = m_r;
#pragma unroll
  for (int k = 0; k < V - 1; ++k) m_l |= (m_l & t) >> 1;
  const uint32_t cond_l = m_l & t & ~1u;
  up = new_up | cond_l | (cond_l >> 1);
  return m_l;
}

// View cell (i, j) before occlusion: the carried object (or empty) at the
// agent cell, else view_cell.
template <int V>
__device__ __forceinline__ int view_value(const int* grid, size_t stride, int W, int H, const ViewFrame& f,
                                          int carry, int i, int j) {
  if (i == V / 2 && j == V - 1) return carry != 0 ? (carry & 0xFFFF) : OBJ_EMPTY;
  return view_cell<V>(grid, stride, W, H, f, i, j);
}

// lit[j], bit i: whether view cell (i, j) is seen (hide_unseen's flood,
// on the cells view_value gives), every bit with SEE_THROUGH.  The rows
// are unrolled so that lit stays in registers; a row's cells are not.
template <int V, bool SEE_THROUGH>
__device__ __forceinline__ void view_lit(const int* grid, size_t stride, int W, int H, const ViewFrame& f,
                                         int carry, uint32_t (&lit)[V]) {
  constexpr uint32_t FULL = V >= 32 ? 0xFFFFFFFFu : (1u << V) - 1u;
  uint32_t up = 1u << (V / 2);
#pragma unroll
  for (int j = V - 1; j >= 0; --j) {
    if (SEE_THROUGH) {
      lit[j] = FULL;
      continue;
    }
    uint32_t t = 0;
#pragma unroll 1
    for (int i = 0; i < V; ++i) t |= see_behind(view_value<V>(grid, stride, W, H, f, carry, i, j)) ? 1u << i : 0u;
    lit[j] = flood_row_u32<V>(t, up);
  }
}

// The learner's one-hot features (rl/model.embed_obs_packed): per view cell
// 11 type, 6 color and 3 state rows, cells major, then 4 direction rows.
constexpr int FEATURES_PER_CELL = NUM_OBJECTS + NUM_COLORS + 3;

// The feature rows that view cell `slot` holding packed cell `p` selects;
// -1 for a type or color out of range, which selects no row, as the one-hot
// comparison does.  The state is clipped to [0, 2].
struct CellRows {
  int type, color, state;
};

__device__ __forceinline__ CellRows cell_rows(int p, int slot) {
  const int t = p & 0xFF;
  const int c = (p >> 8) & 0xFF;
  const int s = min((p >> 16) & 0xFF, 2);
  const int base = slot * FEATURES_PER_CELL;
  return CellRows{t < NUM_OBJECTS ? base + t : -1, c < NUM_COLORS ? base + NUM_OBJECTS + c : -1,
                  base + NUM_OBJECTS + NUM_COLORS + s};
}

// The feature rows of W1 that a view cell holding packed cell `p` selects,
// as bits from the cell's first row (cell_rows at slot 0).
__device__ __forceinline__ uint32_t cell_bits(int p) {
  const CellRows r = cell_rows(p, 0);
  return (r.type >= 0 ? 1u << r.type : 0u) | (r.color >= 0 ? 1u << r.color : 0u) | (1u << r.state);
}

// The direction's feature row after the V2 cells' rows, or -1 outside [0, 4).
__device__ __forceinline__ int direction_row(int d, int V2) {
  return d >= 0 && d < 4 ? V2 * FEATURES_PER_CELL + d : -1;
}

}  // namespace minigrid
