// L2 lc_receive: sendSignal / receiveSignal arbitration, yieldSpeed and the
// change decision (reference vehicle.cpp:391-401, lanechange.cpp:186-206).
//
// Replaces the receiver loop of lc_phase in cityflow_tpu/core/ring_lc.py
// (:313-367): there 2 * SL where-steps over (SL, LNp) slabs of the sender
// bundles permuted to both neighbour columns, every receiver slot testing
// every sender row. A sender targets two receivers only: slot tl_slot as
// leader and tl_slot + 1 as follower. So here one thread owns one column
// (lane p, env b), envs across the warp (every (S, N, B) read coalesced):
//   1. it walks the sender rows of its inner column (direction +1), then of
//      its outer column (direction -1), slots ascending, once each. It reads
//      plan first, dirc on plan rows, tl_slot and pri on rows of the wanted
//      direction, and offers each sender to receiver tl_slot (leader role)
//      and tl_slot + 1 (follower role): a receiver keeps the (priority,
//      sender row, role) of a per-thread table in shared memory, replaced
//      only on a strictly greater signed priority. The first sender of the
//      highest priority in inner-then-outer, slot-ascending order wins, as
//      `better = cand & (~got | pri > best)` keeps it;
//   2. it walks its receivers once and writes yv and do_change, reading the
//      kept follower-role sender's speed, ygap and (template mode) tpl by
//      row index.
// That reads each sender row once per column that reads it, where the TPU
// form read it once per receiver slot: O(SL) per column, not O(SL^2).
//
// Precondition (L1's plan = occ & ...): plan is set only on occupied rows,
// s < n_l. The sender walk stops at the neighbour's n_l, and receivers past
// their own n_l take yv = 100, do_change = false without a read.
//
// The table holds SC = min(S, RC_TABLE) receiver slots for each of the
// block's columns (8 bytes each: at most 48 KB a block, no opt-in): a
// column with more occupied slots takes its receivers in chunks of SC and
// walks its senders once per chunk.
//
// The template mode (non-uniform vehicle templates, ring_lc.py:322-361)
// is its own instantiation: the kept sender's maxNegAcc and the receiver's
// come from their templates (the ring's `tpl` channel and the (TP, 12)
// table) in noCollisionSpeed(srcSpeed, source maxNegAcc, mySpeed, my
// maxNegAcc). The yv arithmetic is the plain version's, op by op (IEEE
// sqrt and division, --fmad=false).
//
// Bound: bytes. yv and do_change of every slot are written (5 bytes a
// slot); the plan flags of the occupied rows of two neighbour columns, the
// receivers' own rows and the senders' fields are read, about once each.
#include "common.cuh"

struct LcReceiveArgs {
  const uint8_t* plan;    // (S, N, B) from L1
  const int* dirc;
  const int* tl_slot;
  const float* ygap;
  const uint8_t* hsig;
  const uint8_t* gval;
  const float* speed;     // state
  const int* pri;
  const int* n_l;         // (N, B)
  const uint8_t* chg;
  const int* inner;       // (N,)
  const int* outer;
  float* yv;              // outputs (S, N, B)
  uint8_t* do_change;
  long long S, N, B;
  float neg, dt;
  const int* tpl;         // template mode: (S, N, B), else null
  const float* table;     //   (TP, 12)
  int TP;
};

#define P_MAXNEGACC 4
#define P_N 12

constexpr int RC_THREADS = 128;   // columns a block, 5 blocks an SM
                                  // (at most 102 registers)
constexpr int RC_TABLE = 48;      // receiver slots a chunk, at most
constexpr int RC_UNROLL = 8;      // sender plan flags loaded together

__device__ __forceinline__ float tneg(const LcReceiveArgs& a, int t) {
  return (t >= 0 && t < a.TP) ? __ldg(&a.table[t * P_N + P_MAXNEGACC])
                              : 0.0f;
}

// a table entry: x the priority, y the code (t * 2 + side) * 2 + follower
// role, -1 none
__device__ __forceinline__ void offer(int2* e, int pr, int code) {
  int2 cur = *e;
  if (cur.y < 0 || pr > cur.x) *e = make_int2(pr, code);
}

template <bool TPL>
__global__ void __launch_bounds__(RC_THREADS, 5)
lc_receive_kernel(const LcReceiveArgs a, int SC) {
  extern __shared__ int2 tab[];     // (SC, blockDim.x)
  const long long NB = a.N * a.B;
  const long long col = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (col >= NB) return;
  const long long p = col / a.B, b = col - p * a.B;
  const int S = (int)a.S;
  // this thread's table: slot r at tab[r * blockDim.x + threadIdx.x]
  int2* my = tab + threadIdx.x;
  const int T = blockDim.x;
  int own = a.n_l[col];
  own = own < 0 ? 0 : (own > S ? S : own);
  int q[2] = {a.inner[p], a.outer[p]};
  int ns[2];
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    int n = q[side] >= 0 ? a.n_l[q[side] * a.B + b] : 0;
    ns[side] = n < 0 ? 0 : (n > S ? S : n);
  }
  const float my_dt = a.dt;
  for (int s0 = 0; s0 < own; s0 += SC) {
    const int nc = min(SC, own - s0);
    for (int r = 0; r < nc; ++r) my[r * T] = make_int2(0, -1);
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int want = side == 0 ? 1 : -1;
      const long long base = (long long)q[side] * a.B + b;
      for (int t0 = 0; t0 < ns[side]; t0 += RC_UNROLL) {
        uint8_t pl[RC_UNROLL];
#pragma unroll
        for (int j = 0; j < RC_UNROLL; ++j)
          pl[j] = t0 + j < ns[side] ? a.plan[(t0 + j) * NB + base] : 0;
#pragma unroll
        for (int j = 0; j < RC_UNROLL; ++j) {
          if (!pl[j]) continue;
          const long long f = (t0 + j) * NB + base;
          if (a.dirc[f] != want) continue;
          // receivers tl (leader role) and tl + 1 (follower role), as
          // chunk rows; 64-bit, so tl = INT_MAX has no follower
          const long long r0 = (long long)a.tl_slot[f] - s0;
          if (r0 < -1 || r0 >= nc) continue;
          const int pr = a.pri[f];
          const int code = ((t0 + j) * 2 + side) * 2;
          if (r0 >= 0) offer(&my[r0 * T], pr, code);
          if (r0 + 1 < nc) offer(&my[(r0 + 1) * T], pr, code | 1);
        }
      }
    }
#pragma unroll 4
    for (int r = 0; r < nc; ++r) {
      const long long e = (s0 + r) * NB + col;
      const int2 best = my[r * T];
      const bool chv = a.chg[e], hs = a.hsig[e];
      const bool received =
          best.y >= 0 && !chv && (!hs || best.x > a.pri[e]);
      float y = 100.0f;
      if (received && (best.y & 1)) {
        const int qs = (best.y >> 1) & 1 ? q[1] : q[0];
        const long long f = (long long)(best.y >> 2) * NB +
                            (long long)qs * a.B + b;
        float vy = TPL ? no_collision_speed(a.speed[f], tneg(a, a.tpl[f]),
                                            a.speed[e], tneg(a, a.tpl[e]),
                                            a.ygap[f], my_dt, 0.0f)
                       : no_collision_speed(a.speed[f], a.neg, a.speed[e],
                                            a.neg, a.ygap[f], my_dt, 0.0f);
        y = vy < 0.0f ? 100.0f : vy;
      }
      a.yv[e] = y;
      a.do_change[e] = !received && !chv && hs && a.plan[e] && a.gval[e] &&
                       a.dirc[e] != 0;
    }
  }
  // receivers past the column's occupied slots: no signal is received, and
  // no plan is set there
  for (long long s = own; s < S; ++s) {
    const long long e = s * NB + col;
    a.yv[e] = 100.0f;
    a.do_change[e] = 0;
  }
}

extern "C" int lc_receive(const LcReceiveArgs* args, void* stream) {
  const LcReceiveArgs& a = *args;
  long long cols = a.N * a.B;
  if (cols == 0 || a.S == 0) return 0;
  // the row code (t * 2 + side) * 2 + role stays an int
  if (a.S > (1LL << 28)) return -1;
  int SC = (int)(a.S < RC_TABLE ? a.S : RC_TABLE);
  long long blocks = (cols + RC_THREADS - 1) / RC_THREADS;
  if (blocks > 0x7FFFFFFFLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = (size_t)SC * RC_THREADS * sizeof(int2);
  if (a.tpl) {
    if (!a.table || a.TP < 1) return -1;
    lc_receive_kernel<true><<<(unsigned)blocks, RC_THREADS, smem, st>>>(a,
                                                                       SC);
  } else {
    lc_receive_kernel<false><<<(unsigned)blocks, RC_THREADS, smem, st>>>(a,
                                                                        SC);
  }
  return (int)cudaGetLastError();
}
