// K2 cross_caps: Cross::canPass for every (row, link, env) over the link's
// KC crosses (reference roadnet.cpp:604-660).
//
// Replaces cross_caps in cityflow_tpu/core/ring.py (:936-996), which the
// TPU evaluates as (R, KC, LPI, G) slabs in one fused loop. Here a thread
// owns one (r, lpi, g, b) and walks its KC crosses in distance order, so the
// (R, KC, ...) intermediates never reach device memory and the any-fail /
// first-fail reductions are register loops.
//
// The template mode (non-uniform vehicle templates, :942-954) reads each
// row's template index `tpl` and takes the subject's maxNegAcc, yield
// distance, length, turn speed, max speed and usualPosAcc from the (TP, 12)
// table (an index outside [0, TP) reads zeros, like the JAX one-hot
// einsum); its own instantiation.
//
// The foe exchange (:881-927, foe_perm / foe_gather) is read in place: a
// cross's 9 foe channels are fields[c, foe_src[kc * LK + col], b] of R1's
// notifier fields, so the (9, KC, LK, B) exchanged slab is never written.
// A cross whose foe_src is -1 has no foe (the gathered slab holds +0.0
// there: foe_exists false, so it passes) and reads nothing.
//
// Bound: bytes. Every row reads its relevant flag and writes 9 bytes; a
// relevant row also reads its 5 floats (and template index), and each foe
// channel is read where the decision tree needs it (chip_smoke.py's
// cross_caps_work counts this data's); the decision tree is ~60 float and
// integer operations per cross, far below the card's rate for that
// traffic.
//
// Design. A block owns one link column and ET = 4 tiles of TB = 32 envs,
// walked in turn (a quarter of the blocks of a tile each, timed 10-25%
// faster on the ring paths, PERF.md), a warp per row (up to RB = 8 rows
// at a time; more rows in further passes), so the R rows of a (column,
// env) meet in one block:
//  - a block whose rows are none of them relevant writes (false, +inf, -1)
//    and is done; so does every row that is not relevant;
//  - the column's cross tables come in chunks of CK = 16 crosses into
//    shared memory, read once for the block's rows; each thread marks the
//    crosses its row considers (valid, ahead of it, with a foe) in a mask
//    and walks the mask, reading a cross's foe channels from R1's fields
//    when it reaches it (the rows of a tile read the same lines, from L1
//    after the first). Copying the considered crosses' channels into
//    shared memory first (cp.async, after a block-wide OR of the masks)
//    was timed slower on every ring path (PERF.md): few rows are
//    relevant, and the copy costs two more barriers a chunk;
//  - the row's own terms of can_yield and getReachSteps (the brake
//    distance, distance_until_speed, the first ceil term of r_b) are
//    computed once per row, and reach_steps evaluates only the branch it
//    takes, and only where the decision reads it: the same operations on
//    the same values, so the results are bitwise the same;
//  - indices are 32-bit, from blockIdx and the block's strides.
// The walk visits a row's crosses in their order, so ties (equal distances
// keep the largest foe lpi, the first zero's sign) resolve as before.
#include "common.cuh"

#define TB 32     // envs of a tile: a warp
#define ET 4      // env tiles of a block, walked in turn
#define RB 8      // rows of a pass
#define CK 16     // crosses of a chunk
#define NCH 9     // foe channels

struct CrossCapsArgs {
  const float* dls;        // (R, LK, B)
  const float* speed;      // (R, LK, B)
  const float* ent;        // (R, LK, B) or null -> ent_val
  const float* ph;         // (R, LK, B) priority high half
  const float* plo;        // (R, LK, B) priority low half
  const uint8_t* relevant; // (R, LK, B)
  const float* d;          // (KC, LK) cross distance
  const uint8_t* cvalid;   // (KC, LK)
  const int* t2;           // (KC, LK) foe link type
  const int* foelpi;       // (KC, LK)
  const int* t1;           // (LK,) own link type
  const uint8_t* turn;     // (LK,)
  const float* fields;     // (9, NF, B) R1's notifier fields
  const int* foe_src;      // (KC, LK) fields row of each cross's foe, or -1
  uint8_t* any_fail;       // (R, LK, B)
  float* ff_d;             // (R, LK, B)
  int* ff_foe;             // (R, LK, B)
  int R, KC, LK, B, NF;
  float ent_val;
  float maxneg, yld, len, turnspd, maxspd, upa, dt;
  const int* tpl;          // template mode: (R, LK, B), else null
  const float* table;      //   (TP, 12)
  int TP;
};

// parameter columns of the template table (compiler/net.py P_*)
enum { P_LEN = 1, P_MAXNEGACC = 4, P_USUALPOSACC = 5, P_MAXSPEED = 8,
       P_YIELD = 10, P_TURNSPEED = 11, P_N = 12 };

__device__ __forceinline__ float tparam(const CrossCapsArgs& a, int t,
                                        int col) {
  return (t >= 0 && t < a.TP) ? __ldg(&a.table[t * P_N + col]) : 0.0f;
}

// a row's terms of can_yield and reach_steps (common.cuh), which do not
// change along its crosses
struct Row {
  float dls, speed, ent, ph, plo;
  float yld, len, target, upa, dt;
  float min_brake;   // 0.5 speed^2 / maxNegAcc (can_yield)
  float sdiv;        // r_fast's divisor
  float dts;         // distance_until_speed(speed, target, upa, dt)
  float rb1;         // r_b's first term
  float ss, acc2;    // speed^2, 2 upa (r_a)
};

// reach_steps(speed, d1, target, upa, dt) clamped to 255, as a float: only
// the branch it selects
__device__ __forceinline__ float reach255(const Row& w, float d1) {
  float r;
  if (d1 <= 0.0f) {
    r = 0.0f;
  } else if (w.speed > w.target) {
    r = ceilf(d1 / w.sdiv);
  } else if (w.dts > d1) {
    r = ceilf((sqrtf(tmax(w.ss + w.acc2 * d1, 0.0f)) - w.speed) / w.upa /
              w.dt);
  } else {
    r = w.rb1 + ceilf((d1 - w.dts) / w.target / w.dt);
  }
  const int sri = xla_f32_to_i32(r);
  return (float)(sri < 255 ? sri : 255);
}

template <bool TPL>
__global__ void __launch_bounds__(TB * RB, 4) cross_caps_kernel(
    const CrossCapsArgs a) {
  __shared__ float s_d[CK];
  __shared__ int s_cv[CK], s_src[CK], s_t2[CK], s_fl[CK];
  const int col = blockIdx.x, x = threadIdx.x;
  const int tid = threadIdx.y * TB + x;
  const int t1 = __ldg(a.t1 + col);
  const bool turn = __ldg(a.turn + col) != 0;

  // the block's ET env tiles in turn
  const int b_end = min(a.B, (int)(blockIdx.y + 1) * ET * TB);
  for (int b0 = blockIdx.y * ET * TB; b0 < b_end; b0 += TB) {
    const int b = b0 + x;
    for (int r0 = 0; r0 < a.R; r0 += blockDim.y) {
      const int r = r0 + threadIdx.y;
      const bool active = r < a.R && b < a.B;
      const int e = (r * a.LK + col) * a.B + b;
      const bool relevant = active && a.relevant[e];
      bool any = false;
      float ffd = INFINITY;
      int ffo = -1;
      if (__syncthreads_or(relevant)) {
        Row w;
        if (relevant) {
          float maxneg = a.maxneg, turnspd = a.turnspd, maxspd = a.maxspd;
          w.yld = a.yld;
          w.len = a.len;
          w.upa = a.upa;
          if (TPL) {
            const int t = a.tpl[e];
            maxneg = tparam(a, t, P_MAXNEGACC);
            w.yld = tparam(a, t, P_YIELD);
            w.len = tparam(a, t, P_LEN);
            turnspd = tparam(a, t, P_TURNSPEED);
            maxspd = tparam(a, t, P_MAXSPEED);
            w.upa = tparam(a, t, P_USUALPOSACC);
          }
          w.dt = a.dt;
          w.dls = a.dls[e];
          w.speed = a.speed[e];
          w.ent = a.ent ? a.ent[e] : a.ent_val;
          w.ph = a.ph[e];
          w.plo = a.plo[e];
          w.target = turn ? turnspd : maxspd;
          w.min_brake = 0.5f * w.speed * w.speed / maxneg;
          w.sdiv = (w.speed > 0.0f) ? w.speed : 1.0f;
          w.dts = distance_until_speed(w.speed, w.target, w.upa, w.dt);
          w.rb1 = ceilf((w.target - w.speed) / w.upa / w.dt);
          w.ss = w.speed * w.speed;
          w.acc2 = 2.0f * w.upa;
        }
        for (int kb = 0; kb < a.KC; kb += CK) {
          const int nk = min(CK, a.KC - kb);
          if (tid < nk) {
            const int tk = (kb + tid) * a.LK + col;
            s_d[tid] = a.d[tk];
            s_cv[tid] = a.cvalid[tk];
            s_src[tid] = __ldg(a.foe_src + tk);
            s_t2[tid] = a.t2[tk];
            s_fl[tid] = a.foelpi[tk];
          }
          __syncthreads();
          // the crosses this row considers that have a foe (a cross without
          // one passes)
          unsigned mine = 0u;
          if (relevant) {
            for (int k = 0; k < nk; ++k)
              if (s_cv[k] && s_d[k] >= w.dls && s_src[k] >= 0) mine |= 1u << k;
          }
          const int cs = a.NF * a.B;           // fields' channel stride
          for (unsigned m = mine; m; m &= m - 1) {
            const int k = __ffs(m) - 1;
            const float* fo = a.fields + s_src[k] * a.B + b;
            if (!(fo[0] > 0.5f)) continue;           // no foe vehicle
            const float dk = s_d[k];
            const float d1 = dk - w.dls;
            const bool self_yield =
                ((d1 > 0.0f) && (w.min_brake < d1 - w.yld)) ||
                ((d1 < 0.0f) && (d1 + w.len < 0.0f));
            if (!self_yield) continue;
            const bool foe_yield = fo[cs] > 0.5f;
            const int t2 = s_t2[k];
            int y;
            if (!foe_yield) {
              y = 1;
            } else if (t1 > t2) {
              y = -1;
            } else {
              const float fdist = fo[5 * cs];
              if (!(fdist > 0.0f)) {
                y = (fo[2 * cs] > 0.5f) ? -1 : 1;      // foe cleared
              } else {
                const float fr = fo[4 * cs];
                const float sr = reach255(w, d1);
                if (t1 < t2) {
                  y = (fr > sr) ? -1 : 1;
                } else {
                  const float fent = fo[6 * cs], fph = fo[7 * cs];
                  const bool pri_win =
                      (w.ph > fph) || ((w.ph == fph) && (w.plo > fo[8 * cs]));
                  y = (fr > sr) ? -1
                      : (fr < sr) ? 1
                      : (w.ent == fent)
                          ? ((d1 == fdist) ? (pri_win ? -1 : 1)
                                           : ((d1 < fdist) ? -1 : 1))
                          : ((w.ent < fent) ? -1 : 1);
                }
              }
            }
            if (y == 1 && fo[3 * cs] > 0.5f) y = -1;  // foe in a cycle
            if (y == -1) continue;                     // passes
            any = true;
            // crosses are distance-ascending; ties keep the largest foe
            // lpi (the reference's min distance, then max foe over equal
            // distances)
            const int fl = s_fl[k];
            if (dk < ffd) {
              ffd = dk;
              ffo = fl;
            } else if (dk == ffd && fl > ffo) {
              ffo = fl;
            }
          }
          __syncthreads();
        }
      }
      if (active) {
        a.any_fail[e] = any;
        a.ff_d[e] = ffd;
        a.ff_foe[e] = ffo;
      }
    }
  }
}

extern "C" int cross_caps(const CrossCapsArgs* args, void* stream) {
  const CrossCapsArgs& a = *args;
  const long long total = (long long)a.R * a.LK * a.B;
  if (total == 0) return 0;
  if (total >= (1LL << 31) || (long long)NCH * a.NF * a.B >= (1LL << 31) ||
      (long long)a.KC * a.LK >= (1LL << 31))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int BT = ET * TB;        // envs of a block
  const dim3 grid((unsigned)a.LK, (unsigned)((a.B + BT - 1) / BT));
  const dim3 block(TB, a.R < RB ? a.R : RB);
  if (grid.y > 65535u) return -1;
  if (a.tpl) {
    if (!a.table || a.TP < 1) return -1;
    cross_caps_kernel<true><<<grid, block, 0, st>>>(a);
  } else {
    cross_caps_kernel<false><<<grid, block, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
