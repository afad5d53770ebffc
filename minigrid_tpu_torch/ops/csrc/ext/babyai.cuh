// BabyAI: the verifier of a level's instruction, then the level's reward
// and termination overlay (minigrid_tpu_torch/envs/babyai/core/
// instr_block.py::BabyAIFusedExt; the JAX package's minigrid_tpu/envs/
// babyai/core/instr_block.py:172-444, itself the block form of instr.py's
// verify_step :314-470 and level.py's _post_step :293-303).
//
// 8 extra scalars, the packed words of instr_block.py:
// top, leaf, d_type, d_color, d_loc, d_plural, carried, mem.  2 extra
// planes of W*H bytes: gridm (the cells holding each tracked
// object now) and poss (the positions the verifier sees), bit leaf*2 + slot
// of each cell.  The reset cache blends both in with the rest of the level.
//
// The TPU kernel holds a cell per lane, so it masks and reduces whole
// planes for every read.  Here one thread owns one env and reads words:
// the gridm word at the front cell of the pose before the step, and the
// poss words at the front cell after it and its 4 neighbours inside the
// grid (PutNext's "next to", the 4-dilation of poss read at one cell).  It
// writes the one gridm word a pickup, a drop or an opened box changes, and
// its only pass over a plane is poss = gridm on a drop action, which some
// lane of a warp takes at nearly every step (1 - (6/7)^32 of them under a
// random policy); the random-policy kernel leaves that copy to the whole
// warp (POSS_ON_DROP, verify<true>).  The leaf
// status machine and the Before/After/And combinators follow the JAX
// package's, word for word.

#pragma once

#include "../fused_ext.cuh"

namespace minigrid {

struct BabyAIExt : NoExt {
  // Objects, a per-episode mission, walls that occlude.
  static constexpr int SWITCHES[3] = {0, 0, 0};
  static constexpr int MAX_K = 8;
  static constexpr int NUM_PLANES = 2;
  static constexpr bool FRONT_BEFORE = true;

  enum { W_TOP, W_LEAF, W_DTYPE, W_DCOLOR, W_DLOC, W_DPLURAL, W_CARRIED, W_MEM };
  enum { LEAF_NONE = -1, LEAF_OPEN = 0, LEAF_GOTO = 1, LEAF_PICKUP = 2 };
  enum { TOP_ACTION = 0, TOP_AND = 1, TOP_BEFORE = 2 };
  enum { CONTINUE = 0, SUCCESS = 1, FAILURE = 2 };

  struct Extra {
    int w[MAX_K];
  };

  __device__ static Extra load(const int* scal, int n, size_t N, const ExtParams&) {
    Extra x;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) x.w[k] = scal[(size_t)k * N + n];
    return x;
  }

  __device__ static void store(int* scal, int n, size_t N, const ExtParams&, const Extra& x) {
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) scal[(size_t)k * N + n] = x.w[k];
  }

  __device__ static bool bit(int word, int b) { return (word >> b) & 1; }

  // A sequence side: a leaf, or an And of two whose sticky successes count
  // and whose failures are swallowed.
  __device__ static int side(bool is_and, const int* st, const bool* sub, int i0, int i1, bool prior) {
    if (!is_and) return prior ? SUCCESS : st[i0];
    const int s0 = sub[i0] ? SUCCESS : st[i0];
    const int s1 = sub[i1] ? SUCCESS : st[i1];
    return s0 == SUCCESS && s1 == SUCCESS ? SUCCESS : CONTINUE;
  }

  // Before/After: the first side, and on its success the same action
  // drives the second; in strict mode the second succeeding first fails.
  __device__ static int then(int first, bool first_prior, int second, bool strict) {
    if (first_prior || first == SUCCESS) return second == FAILURE ? FAILURE : second == SUCCESS ? SUCCESS : CONTINUE;
    if (first == FAILURE) return FAILURE;
    return strict && second == SUCCESS ? FAILURE : CONTINUE;
  }

  static constexpr bool POSS_ON_DROP = true;

  __device__ static bool post_step(const ExtParams& p, const StepCtx& ctx, float& reward, Extra& x) {
    return verify<false>(p, ctx, reward, x);
  }

  // The hook; with WARP_POSS the poss = gridm copy of a drop action is left
  // to the caller's warp (the random-policy kernel), and the hook reads
  // gridm where it would read that copy.
  template <bool WARP_POSS>
  __device__ static bool verify(const ExtParams&, const StepCtx& ctx, float& reward, Extra& x) {
    const size_t N = ctx.N;
    const int W = ctx.W, H = ctx.H, WH = W * H;
    uint8_t* gridm = ctx.planes;
    uint8_t* poss = ctx.planes + (size_t)WH * N;
    const int a = ctx.action;
    const int top = x.w[W_TOP], leafw = x.w[W_LEAF], mem = x.w[W_MEM];
    int carried = x.w[W_CARRIED];

    // Object bookkeeping: a pickup moves the tracked objects at the front
    // cell into the hand, a drop puts the hand's back, an opened box is
    // gone (its contents are new objects).
    const bool prev_held = (ctx.prev.carry & 0xFF) != 0;
    const bool now_held = (ctx.post.carry & 0xFF) != 0;
    const bool picked = !prev_held && now_held;
    const bool dropped = prev_held && !now_held;
    const size_t fidx = (size_t)ctx.front * N;
    const bool box_consumed =
        a == ACT_TOGGLE && (ctx.front_before & 0xFF) == OBJ_BOX && (ctx.grid[fidx] & 0xFF) != OBJ_BOX;
    const int at_fwd = gridm[fidx];
    int word = at_fwd;
    if (picked) {
      carried |= at_fwd;
      word = 0;
    } else if (dropped) {
      word = at_fwd | carried;
      carried = 0;
    } else if (box_consumed) {
      word = 0;
    }
    if (word != at_fwd) gridm[fidx] = (uint8_t)word;
    // update_objs_poss on a drop action.
    if (!WARP_POSS && a == ACT_DROP) {
      for (int k = 0; k < WH; ++k) poss[(size_t)k * N] = gridm[(size_t)k * N];
    }
    const uint8_t* seen = WARP_POSS && a == ACT_DROP ? gridm : poss;

    // The front cell of the pose after the step, and poss around it.
    const Cell fn = front_cell(ctx.post, W, H);
    const int now = fn.x * H + fn.y;
    const int fcell_now = ctx.grid[(size_t)now * N];
    const int fnow_type = fcell_now & 0xFF;
    const int fnow_state = (fcell_now >> 16) & 0xFF;
    const int poss_now = seen[(size_t)now * N];
    int near = 0;
    if (fn.x + 1 < W) near |= seen[(size_t)(now + H) * N];
    if (fn.x > 0) near |= seen[(size_t)(now - H) * N];
    if (fn.y + 1 < H) near |= seen[(size_t)(now + 1) * N];
    if (fn.y > 0) near |= seen[(size_t)(now - 1) * N];

    // Each leaf's status; in done-actions mode only a done action reports,
    // from the leaf's last match.
    const bool done_mode = bit(top, 5);
    const bool is_done_act = done_mode && a == ACT_DONE;
    int raw[4], st[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int kind = ((leafw >> (3 * l)) & 7) - 1;
      const bool strict = bit(leafw, 12 + l);
      const int b0 = 2 * l, b1 = 2 * l + 1;
      bool succ, fail;
      if (kind == LEAF_OPEN) {
        succ = a == ACT_TOGGLE && bit(word, b0) && fnow_type == OBJ_DOOR && fnow_state == STATE_OPEN;
        fail = strict && a == ACT_TOGGLE && fnow_type == OBJ_DOOR;
      } else if (kind == LEAF_GOTO) {
        succ = bit(poss_now, b0);
        fail = false;
      } else if (kind == LEAF_PICKUP) {
        succ = a == ACT_PICKUP && bit(mem, l) && bit(carried, b0);
        fail = strict && a == ACT_PICKUP && now_held;
      } else {  // PutNext
        succ = a == ACT_DROP && dropped && bit(mem, 4 + l) && bit(near, b1);
        fail = strict && a == ACT_PICKUP && now_held;
      }
      raw[l] = kind == LEAF_NONE ? CONTINUE : succ ? SUCCESS : fail ? FAILURE : CONTINUE;
      st[l] = !done_mode ? raw[l] : !is_done_act ? CONTINUE : bit(mem, 8 + l) ? SUCCESS : FAILURE;
    }

    // The combinators.
    const int top_kind = top & 3;
    const bool a_is_and = bit(top, 2), b_is_and = bit(top, 3), strict_top = bit(top, 4);
    bool sub[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) sub[l] = bit(mem, 12 + l);
    const bool a_prior = bit(mem, 16), b_prior = bit(mem, 17);
    const int a_status = side(a_is_and, st, sub, 0, 1, a_prior);
    const int b_status = side(b_is_and, st, sub, 2, 3, b_prior);
    const bool is_action = top_kind == TOP_ACTION, is_and = top_kind == TOP_AND;
    const bool is_before = top_kind == TOP_BEFORE, is_after = top_kind == 3;
    const int status = is_action   ? st[0]
                       : is_and    ? side(true, st, sub, 0, 1, false)
                       : is_before ? then(a_status, a_prior, b_status, strict_top)
                                   : then(b_status, b_prior, a_status, strict_top);

    // The leaves called this step, their memory and the stickies.
    const bool a_called = is_action || is_and || (is_before && !a_prior) ||
                          (is_after && (b_prior || b_status == SUCCESS || strict_top));
    const bool b_called =
        is_and || (is_before && (a_prior || a_status == SUCCESS || strict_top)) || (is_after && !b_prior);
    const bool called[4] = {a_called && !sub[0], a_called && a_is_and && !sub[1], b_called && !sub[2],
                            b_called && b_is_and && !sub[3]};
    int new_mem = 0;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const bool mu = called[l] && !is_done_act;
      const bool pre_none = mu ? !now_held : bit(mem, l);
      const bool pre_move = mu ? bit(carried, 2 * l) : bit(mem, 4 + l);
      const bool last = done_mode && mu ? raw[l] == SUCCESS : bit(mem, 8 + l);
      const bool sticky = sub[l] || (called[l] && st[l] == SUCCESS);
      new_mem |= (pre_none << l) | (pre_move << (4 + l)) | (last << (8 + l)) | (sticky << (12 + l));
    }
    const bool a_live = is_before || (is_after && (b_prior || b_status == SUCCESS));
    const bool b_live = is_after || (is_before && (a_prior || a_status == SUCCESS));
    new_mem |= (int)(a_prior || (a_live && a_status == SUCCESS)) << 16;
    new_mem |= (int)(b_prior || (b_live && b_status == SUCCESS)) << 17;
    x.w[W_CARRIED] = carried;
    x.w[W_MEM] = new_mem;

    // RoomGridLevel._post_step: success rewards, failure zeroes the reward,
    // either ends the episode.
    if (status == SUCCESS) reward = success_reward(ctx.post);
    if (status == FAILURE) reward = 0.0f;
    return status != CONTINUE;
  }
};

}  // namespace minigrid
