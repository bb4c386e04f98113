// K3 car_follow: getIntersectionRelatedSpeed + Vehicle::getNextSpeed's
// min-rule, fused elementwise (reference vehicle.cpp:308-376).
//
// Replaces isr_speed and min_chain in cityflow_tpu/core/ring.py
// (:998-1092), applied on link rows, approach rows and lane rows
// (:1094-1369). Mode bit 1 runs isr_speed, bit 2 runs min_chain; with both,
// the intersection speed stays in a register. The lane-change mode is
// min_chain with the yieldSpeed input v_yield (:1081), raw on the
// lane-change path; it is its own instantiation (YIELD = true).
//
// The template mode (non-uniform vehicle templates, :1001-1064) is its own
// instantiation (TPL = true): every element reads its vehicle's template
// index `tpl` and, for min_chain, its leader's `lead_tpl` (both of the
// output's full shape), and takes the parameters from the (TP, 12) table
// instead of the scalar arguments: its own maxSpeed, turnSpeed,
// usualPosAcc, usualNegAcc, yieldDistance, maxNegAcc, minGap, headwayTime,
// maxPosAcc, and the leader's maxNegAcc and usualNegAcc in the
// no-collision terms (vehicle.cpp:217, 229). An index outside [0, TP) reads
// zeros, like the JAX one-hot einsum (_PP, :270-297).
//
// The ring-leader mode (RING = 1 lane rows, 2 link rows; :1094-1150 and
// :1301-1386) replaces the leader views the JAX step builds by shifting
// each ring one slot (a TPU shift plan) and the where-chains around them:
// slot s's leader is slot s - 1 of the ring itself (none at s = 0; has_lead
// = s - 1 < n), the gap (lead_dis - lead_len) - dis in that order, and on
// lane rows lane_left = ln_len - dis and invalid = occupied & nxt < 0 &
// !last. On link rows slot 0's leader is the end-lane tail, read from the
// end-lane bundle `s0` (dis, speed, exists, template channels): its gap is
// ((lk_len - dis) + tail_dis) - tail_len. On lane rows the front slots
// s < AP of a lane with an in-lane (in_inv >= 0) whose approach row is
// relevant (ap_rel) take the approach result ap_v (and ap_d) instead. It
// also writes the new distance dis + delta (or ap_d) where not raw.
//
// Bound: bytes. Up to 12 inputs of 4 or 1 bytes and 2-3 outputs per
// element, each input counted only where its branch reads it
// (chip_smoke.py's k3_work counts this data's), against ~80 float
// operations: well under the card's float rate.
//
// Design. The call's shape is (S, d1, d2, d3): S slots (rows) over
// d1 * d2 * d3 columns, d3 the envs. A thread owns V = 4 adjacent envs
// of one column, with 16-byte loads and stores, where d3 % 4 == 0 and
// every view is aligned, else one env (V = 1); and it walks s = 0 .. S - 1
// in order:
//  - views by strides: each input carries its element strides over the four
//    dimensions (0 where it broadcasts), in 32-bit; the thread splits its
//    column index into (i1, i2, i3) once, and slot s adds s * st0;
//  - leaders in registers: in the ring-leader mode slot s's leader is what
//    the thread read at slot s - 1, so each ring value is read once; where
//    the call passes the ring's own speed (distance) array as the speed
//    (dls) input, the launcher sees it and the kernel reads it once;
//  - parameter-only terms once: the subject's parameters and the terms of
//    no_collision_speed, stop_before_speed, the headway speed and the speed
//    bounds that depend on them alone (0.5 / maxNegAcc, 0.5 / (0.5 /
//    maxNegAcc), usualPosAcc * interval, headway + interval / 2, ...)
//    come derived (Der): in the uniform mode once by the launcher, into
//    the kernel's parameter space; in the template mode by the block into
//    shared memory, a row per template (the first TPS; a template above
//    that is derived where it is read, by the same function) and a row of
//    zeros for an index outside [0, TP). Each term is the same IEEE f32
//    operation on the same values as the elementwise form, so every
//    output is bitwise the same;
//  - branches only where taken: no_collision_speed returns -100 before its
//    square root, stop_before_speed its accelerating speed before the
//    interval count, the leader terms run only where there is a leader,
//    the delta on its side of the sign test, and inputs only one branch
//    reads (custom, ff_d, the ring's nxt / last) are loaded where a lane of
//    the thread takes it; flags travel as lane masks;
//  - registers: at most 128 a thread (two blocks of 256 an SM), none
//    spilled; the card's time follows the registers more than anything
//    else here (PERF.md).
// Built with --fmad=false: each operation rounds on its own.
#include "common.cuh"

#define MINB 2            // blocks of 256 threads an SM must hold: at most
                          // 128 registers a thread, none spilled (3: 80,
                          // faster on uniform calls but spilling; timed)
#define TPS 64            // template rows derived into shared memory

enum {
  IN_SPEED = 0,
  IN_DLS,
  IN_ISR_LANE_LEFT,
  IN_ANY_FAIL,
  IN_FF_D,
  IN_APP,
  IN_AVAIL,
  IN_CAN_ENTER,
  IN_TURN,
  IN_GAP,
  IN_LEAD_SPD,
  IN_HAS_LEAD,
  IN_V_ISR,
  IN_ISR_REL,
  IN_CUSTOM,
  IN_HAS_CUSTOM,
  IN_DRV_MAXSPD,
  IN_INVALID,
  IN_LANE_LEFT,
  IN_V_YIELD,
  N_IN
};

struct View {
  const void* p;        // null: every element reads `val`
  int st[4];            // element strides over the call's (S, d1, d2, d3),
                        // 0 where the input broadcasts
  float val;
  int is_bool;
};

// a vehicle's parameters and the terms that depend on them (and the
// interval) alone
struct Der {
  float maxspd, turnspd, upa, una, yld, maxneg, mingap, len;
  float upadt;      // usualPosAcc * interval
  float maxposdt;   // maxPosAcc * interval
  float maxnegdt;   // maxNegAcc * interval
  float hw;         // headwayTime + interval / 2
  float a4h, iah;   // 4 a, 0.5 / a of a = 0.5 / maxNegAcc
  float a4s, ias;   // the same of a = 0.5 / usualNegAcc
};

struct CarFollowArgs {
  View in[N_IN];
  float* out_v;         // isr only: v_isr; else the new speed (or raw v)
  float* out_delta;     // min_chain (not raw): distance increment
  uint8_t* out_red;     // isr only: red_stop
  int d[4];             // the call's shape (S, d1, d2, d3)
  int mode;             // 1 = isr, 2 = min_chain, 3 = both
  int raw;
  float maxspd, turnspd, upa, una, yld, maxneg, mingap, headway, maxpos, dt;
  int with_yield;       // 1: the lane-change mode (v_yield input)
  const int* tpl;       // template mode: own template index, full shape
  const int* lead_tpl;  //   the leader's (min_chain, not the ring mode)
  const float* table;   //   (TP, 12) template parameters
  int TP;
  // ring-leader mode (0 off, 1 lane rows, 2 link rows): rings (S, N, B),
  // N = d1 * d2, B = d3
  int ring;
  const float* r_dis;     // the ring's distances (the subject's too)
  const float* r_spd;     // its speeds (the leader's)
  const int* r_tpl;       // its templates (template mode)
  const int* r_n;         // (N, B) occupied slots
  const float* len_row;   // (N,) lane / link length
  float lead_len;         // uniform leader length
  float* out_dis;         // not raw: the new distance
  // lane rows
  const int* r_nxt;       // (S, N, B)
  const uint8_t* r_last;
  const int* in_inv;      // (N,) in-lane row of each lane, or -1
  const float* ap_v;      // (AP, ILG, B) approach speed
  const float* ap_d;      // (AP, ILG, B) approach distance (not raw)
  const uint8_t* ap_rel;  // (AP, ILG, B)
  int AP, ILG;
  // link rows: the end-lane bundle (CE, N, B), channels dis, speed,
  // exists, template
  const float* s0;
  int s0_dis, s0_spd, s0_ex, s0_tpl;
  // set by the launcher: the speed (dls) view is the ring's own speed
  // (distance) array, so the kernel reads it once; the uniform mode's
  // derived parameters and 0.5 dt, (0.5 dt)^2, in the parameter space
  int spd_ring, dls_ring;
  Der U;
  float hb, hbb;
};

// parameter columns of the template table (compiler/net.py P_*)
enum {
  P_SPEED = 0, P_LEN, P_WIDTH, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC,
  P_USUALNEGACC, P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED,
  P_N
};

__host__ __device__ __forceinline__ Der derive(float maxspd, float turnspd, float upa,
                                      float una, float yld, float maxneg,
                                      float mingap, float headway,
                                      float maxpos, float len, float dt) {
  Der r;
  r.maxspd = maxspd;
  r.turnspd = turnspd;
  r.upa = upa;
  r.una = una;
  r.yld = yld;
  r.maxneg = maxneg;
  r.mingap = mingap;
  r.len = len;
  r.upadt = upa * dt;
  r.maxposdt = maxpos * dt;
  r.maxnegdt = maxneg * dt;
  r.hw = headway + dt / 2.0f;
  const float ah = 0.5f / maxneg, as = 0.5f / una;
  r.a4h = 4.0f * ah;
  r.iah = 0.5f / ah;
  r.a4s = 4.0f * as;
  r.ias = 0.5f / as;
  return r;
}

__device__ __forceinline__ Der derive_row(const float* t, float dt) {
  return derive(__ldg(t + P_MAXSPEED), __ldg(t + P_TURNSPEED),
                __ldg(t + P_USUALPOSACC), __ldg(t + P_USUALNEGACC),
                __ldg(t + P_YIELD), __ldg(t + P_MAXNEGACC),
                __ldg(t + P_MINGAP), __ldg(t + P_HEADWAY),
                __ldg(t + P_MAXPOSACC), __ldg(t + P_LEN), dt);
}

// template t's row: row TPS holds the zeros of an index outside [0, TP)
__device__ __forceinline__ Der tder(const Der* tab, const CarFollowArgs& a,
                                    int t) {
  if (t < 0 || t >= a.TP) return tab[TPS];
  if (t < TPS) return tab[t];
  return derive_row(a.table + (size_t)t * P_N, a.dt);
}

// no_collision_speed (common.cuh, vehicle.cpp:200-209) of a subject whose
// dF terms are a4 = 4 (0.5 / dF) and ia = 0.5 / (0.5 / dF); hb = 0.5 dt,
// hbb = hb * hb. The same operations in the same order.
__device__ __forceinline__ float ncs(float vL, float dL, float vF, float gap,
                                     float tg, float a4, float ia, float dt,
                                     float hb, float hbb) {
  const float c = vF * dt / 2.0f + tg - 0.5f * vL * vL / dL - gap;
  if (hbb < a4 * c) return -100.0f;
  const float disc = hbb - a4 * c;
  const float v1 = ia * (sqrtf(tmax(disc, 0.0f)) - hb);
  const float v2 = 2.0f * vL - dL * dt + 2.0f * (gap - tg) / dt;
  return tmin(v1, v2);
}

// stop_before_speed (common.cuh, vehicle.cpp:240-250), upadt = upa * dt
__device__ __forceinline__ float sbs(float speed, float upadt, float una,
                                     float distance, float dt) {
  const float next = speed + upadt;
  const float bda = (speed + next) * dt / 2.0f + (next * next / una / 2.0f);
  if (bda < distance) return speed + upadt;
  const float ti = 2.0f * distance / (speed + 1e-8f) / dt;
  // (int)takeInterval: C truncation; x86 cvttsd2si out of range -> INT_MIN
  const float ti_int =
      (fabsf(ti) >= 2147483648.0f) ? -2147483648.0f : truncf(ti);
  return speed - speed / ((ti >= 1.0f) ? ti_int : ti);
}

// ---- loads of V adjacent envs ----------------------------------------------

// V adjacent values at p (aligned to V of them where V > 1)
template <int V>
__device__ __forceinline__ void ldv(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg((const float4*)p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void ldv(const int* p, int (&x)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg((const int4*)p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void ldv(const uint8_t* p, uint8_t (&x)[V]) {
  if constexpr (V == 4) {
    const uchar4 q = __ldg((const uchar4*)p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else {
    x[0] = __ldg(p);
  }
}

// a view's V envs from element offset o (its st[3] is 0 or 1)
template <int V>
__device__ __forceinline__ void ldf(const View& v, int o, float (&x)[V]) {
  if (!v.p) {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = v.val;
  } else if (v.is_bool) {
    uint8_t u[V];
    if (v.st[3]) {
      ldv<V>((const uint8_t*)v.p + o, u);
    } else {
      u[0] = __ldg((const uint8_t*)v.p + o);
#pragma unroll
      for (int j = 1; j < V; ++j) u[j] = u[0];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = u[j] ? 1.0f : 0.0f;
  } else if (v.st[3]) {
    ldv<V>((const float*)v.p + o, x);
  } else {
    x[0] = __ldg((const float*)v.p + o);
#pragma unroll
    for (int j = 1; j < V; ++j) x[j] = x[0];
  }
}

// V bytes at p as a lane mask: bit j set where byte j is not 0
template <int V>
__device__ __forceinline__ unsigned ldcm(const uint8_t* p) {
  if constexpr (V == 4) {
    const unsigned w = __ldg((const unsigned*)p);
    return (w & 0xffu ? 1u : 0u) | (w & 0xff00u ? 2u : 0u) |
           (w & 0xff0000u ? 4u : 0u) | (w & 0xff000000u ? 8u : 0u);
  } else {
    return __ldg(p) ? 1u : 0u;
  }
}

// a view's V envs from element offset o, as a lane mask (value != 0)
template <int V>
__device__ __forceinline__ unsigned ldm(const View& v, int o) {
  constexpr unsigned all = (1u << V) - 1u;
  if (!v.p) return v.val != 0.0f ? all : 0u;
  if (v.is_bool) {
    const uint8_t* p = (const uint8_t*)v.p + o;
    if (v.st[3]) return ldcm<V>(p);
    return __ldg(p) ? all : 0u;
  }
  float f[V];
  ldf<V>(v, o, f);
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) m |= (f[j] != 0.0f ? 1u : 0u) << j;
  return m;
}

template <int V>
__device__ __forceinline__ void stc(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *(float4*)p = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// a lane mask as V bytes 0 / 1 at p
template <int V>
__device__ __forceinline__ void stm(uint8_t* p, unsigned m) {
  if constexpr (V == 4) {
    *(unsigned*)p = (m & 1u) | (m & 2u) << 7 | (m & 4u) << 14 | (m & 8u) << 21;
  } else {
    *p = (uint8_t)m;
  }
}

template <bool YIELD, bool TPL, int RING, int V>
__global__ void __launch_bounds__(256, MINB) car_follow_kernel(
    const CarFollowArgs a) {
  __shared__ Der tab[TPL ? TPS + 1 : 1];
  const float dt = a.dt;
  if (TPL) {
    for (int t = threadIdx.x; t <= TPS; t += blockDim.x) {
      if (t == TPS)
        tab[t] = derive(0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                        0.0f, 0.0f, dt);
      else if (t < a.TP)
        tab[t] = derive_row(a.table + t * P_N, dt);
    }
    __syncthreads();
  }

  const int S = a.d[0], d2 = a.d[2], d3 = a.d[3];
  const int NC = a.d[1] * d2 * d3;     // columns; rings (S, N, B): N B = NC
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= NC) return;
  const int i3 = c % d3, n = c / d3, i2 = n % d2, i1 = n / d2;
  auto off = [&](int k, int s) {
    const int* st = a.in[k].st;
    return s * st[0] + i1 * st[1] + i2 * st[2] + i3 * st[3];
  };
  const float hb = a.hb, hbb = a.hbb;
  const Der& U = a.U;          // the uniform mode's parameters

  // the leader carried from slot to slot (ring-leader mode)
  float ld_dis[V], ld_spd[V], s0_dis[V];
  int ld_tpl[V], nocc[V];
  unsigned has0 = 0u;              // link rows: slot 0 has an end-lane tail
  float lrow = 0.0f;
  int inv = -1;
  if (RING) {
    ldv<V>(a.r_n + c, nocc);
    lrow = __ldg(a.len_row + n);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ld_dis[j] = 1e9f;
      ld_spd[j] = 0.0f;
      ld_tpl[j] = 0;
    }
    if (RING == 1) {
      inv = __ldg(a.in_inv + n);
    } else {
      float ex[V], tt[V];
      ldv<V>(a.s0 + a.s0_spd * NC + c, ld_spd);
      ldv<V>(a.s0 + a.s0_ex * NC + c, ex);
      ldv<V>(a.s0 + a.s0_dis * NC + c, s0_dis);
      if (TPL) ldv<V>(a.s0 + a.s0_tpl * NC + c, tt);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        has0 |= (ex[j] > 0.5f ? 1u : 0u) << j;
        if (TPL) ld_tpl[j] = xla_f32_to_i32(tt[j]);
      }
    }
  }

  for (int s = 0; s < S; ++s) {
    const int e = s * NC + c;
    float speed[V], dis[V], spd_r[V];
    int tp[V], tpl_r[V];
    if (RING) {
      ldv<V>(a.r_dis + e, dis);
      ldv<V>(a.r_spd + e, spd_r);
      if (TPL) ldv<V>(a.r_tpl + e, tpl_r);
    }
    if (RING && a.spd_ring) {
#pragma unroll
      for (int j = 0; j < V; ++j) speed[j] = spd_r[j];
    } else {
      ldf<V>(a.in[IN_SPEED], off(IN_SPEED, s), speed);
    }
    if (TPL) ldv<V>(a.tpl + e, tp);

    // ---- isr_speed
    float v_isr[V];
    if (a.mode & 1) {
      const unsigned app = ldm<V>(a.in[IN_APP], off(IN_APP, s));
      const unsigned af = ldm<V>(a.in[IN_ANY_FAIL], off(IN_ANY_FAIL, s));
      const unsigned red =
          app & ~(ldm<V>(a.in[IN_AVAIL], off(IN_AVAIL, s)) &
                  ldm<V>(a.in[IN_CAN_ENTER], off(IN_CAN_ENTER, s)));
      const unsigned turn = app & ldm<V>(a.in[IN_TURN], off(IN_TURN, s));
      float ll[V], ffd[V], dls[V];
      if (red)
        ldf<V>(a.in[IN_ISR_LANE_LEFT], off(IN_ISR_LANE_LEFT, s), ll);
      if (af) {
        ldf<V>(a.in[IN_FF_D], off(IN_FF_D, s), ffd);
        if (RING && a.dls_ring) {
#pragma unroll
          for (int j = 0; j < V; ++j) dls[j] = dis[j];
        } else {
          ldf<V>(a.in[IN_DLS], off(IN_DLS, s), dls);
        }
      }
      unsigned red_stop = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const Der D = TPL ? tder(tab, a, tp[j]) : U;
        const float sp = speed[j];
        bool rs = false;
        if (red >> j & 1u) {
          const float min_brake = 0.5f * sp * sp / D.maxneg;
          rs = !(min_brake > ll[j]);
        }
        if (rs) {
          red_stop |= 1u << j;
          v_isr[j] = ref_min(D.maxspd, sbs(sp, D.upadt, D.una, ll[j], dt));
        } else {
          float v = D.maxspd;
          if (turn >> j & 1u) v = tmin(v, D.turnspd);
          if (af >> j & 1u)
            v = ref_min(v, sbs(sp, D.upadt, D.una, ffd[j] - dls[j] - D.yld,
                               dt));
          v_isr[j] = v;
        }
      }
      if (!(a.mode & 2)) {
        stc<V>(a.out_v + e, v_isr);
        stm<V>(a.out_red + e, red_stop);
        continue;
      }
    } else {
      ldf<V>(a.in[IN_V_ISR], off(IN_V_ISR, s), v_isr);
    }

    // ---- min_chain: which lanes have a leader, which are invalid
    unsigned has = 0u, invalid = 0u;
    float gap[V], lspd[V], lane_left[V];
    int ltp[V];
    if (RING) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        has |= ((s == 0) ? (has0 >> j & 1u) : (s - 1 < nocc[j] ? 1u : 0u))
               << j;
      if (RING == 1) {
        unsigned occ = 0u;
#pragma unroll
        for (int j = 0; j < V; ++j) occ |= (s < nocc[j] ? 1u : 0u) << j;
        if (occ) {
          int nx[V];
          ldv<V>(a.r_nxt + e, nx);
          const unsigned last = ldcm<V>(a.r_last + e);
#pragma unroll
          for (int j = 0; j < V; ++j)
            invalid |= ((occ >> j & 1u) && nx[j] < 0 && !(last >> j & 1u)
                            ? 1u : 0u) << j;
        }
      } else {
        ldf<V>(a.in[IN_LANE_LEFT], off(IN_LANE_LEFT, s), lane_left);
        invalid = ldm<V>(a.in[IN_INVALID], off(IN_INVALID, s));
      }
    } else {
      has = ldm<V>(a.in[IN_HAS_LEAD], off(IN_HAS_LEAD, s));
      if (has) {
        ldf<V>(a.in[IN_GAP], off(IN_GAP, s), gap);
        ldf<V>(a.in[IN_LEAD_SPD], off(IN_LEAD_SPD, s), lspd);
        if (TPL) ldv<V>(a.lead_tpl + e, ltp);
      }
      ldf<V>(a.in[IN_LANE_LEFT], off(IN_LANE_LEFT, s), lane_left);
      invalid = ldm<V>(a.in[IN_INVALID], off(IN_INVALID, s));
    }
    const unsigned isr_rel = ldm<V>(a.in[IN_ISR_REL], off(IN_ISR_REL, s));
    const unsigned hc = ldm<V>(a.in[IN_HAS_CUSTOM], off(IN_HAS_CUSTOM, s));
    float custom[V], dmax[V], vy[V];
    if (hc) ldf<V>(a.in[IN_CUSTOM], off(IN_CUSTOM, s), custom);
    ldf<V>(a.in[IN_DRV_MAXSPD], off(IN_DRV_MAXSPD, s), dmax);
    if (YIELD) ldf<V>(a.in[IN_V_YIELD], off(IN_V_YIELD, s), vy);

    // ---- min_chain, a lane at a time
    float vout[V], delta[V], ndis[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const Der D = TPL ? tder(tab, a, tp[j]) : U;
      const float sp = speed[j];
      float v_cf;
      if (has >> j & 1u) {
        // the leader: slot s - 1 (the end-lane tail at a link's slot 0)
        float vL, g;
        Der L = U;
        if (RING) {
          vL = ld_spd[j];
          if (TPL) L = tder(tab, a, ld_tpl[j]);
          const float lead_len = TPL ? L.len : a.lead_len;
          g = (RING == 2 && s == 0)
                  ? ((lrow - dis[j]) + s0_dis[j]) - lead_len
                  : (ld_dis[j] - lead_len) - dis[j];
        } else {
          vL = lspd[j];
          g = gap[j];
          if (TPL) L = tder(tab, a, ltp[j]);
        }
        const float v_hard =
            ncs(vL, L.maxneg, sp, g, 0.0f, D.a4h, D.iah, dt, hb, hbb);
        if (hc >> j & 1u) {
          v_cf = tmin(custom[j], v_hard);
        } else {
          const float assume_decel = (sp > vL) ? sp - vL : 0.0f;
          const float v_soft =
              ncs(vL, L.una, sp, g, D.mingap, D.a4s, D.ias, dt, hb, hbb);
          const float v_headway =
              ((g + (vL + assume_decel / 2.0f) * dt - sp * dt / 2.0f) /
               D.hw);
          v_cf = tmin(tmin(v_hard, v_soft), v_headway);
        }
      } else {
        v_cf = (hc >> j & 1u) ? custom[j] : D.maxspd;
      }
      float v = tmin(D.maxspd, sp + D.maxposdt);
      v = tmin(v, dmax[j]);
      v = tmin(v, v_cf);
      if (isr_rel >> j & 1u) v = tmin(v, v_isr[j]);
      if (YIELD) v = tmin(v, vy[j]);
      if (invalid >> j & 1u) {
        const float left = (RING == 1) ? lrow - dis[j] : lane_left[j];
        v = tmin(v, ncs(0.0f, 1.0f, sp, left, D.mingap, D.a4h, D.iah, dt,
                        hb, hbb));
      }
      v = tmax(v, sp - D.maxnegdt);
      vout[j] = v;
      if (!a.raw) {
        const bool neg = v < 0.0f;
        delta[j] = neg ? 0.5f * sp * sp / D.maxneg : (sp + v) * dt / 2.0f;
        vout[j] = neg ? 0.0f : v;
        if (RING) ndis[j] = dis[j] + delta[j];
      }
      if (RING) {          // the next slot's leader
        ld_dis[j] = dis[j];
        ld_spd[j] = spd_r[j];
        if (TPL) ld_tpl[j] = tpl_r[j];
      }
    }

    // ring lane rows: a front slot whose approach row is relevant takes the
    // approach result
    if (RING == 1 && s < a.AP && inv >= 0) {
      const int q = (s * a.ILG + inv) * d3 + i3;
      const unsigned over = ldcm<V>(a.ap_rel + q);
      if (over) {
        float ov_v[V], ov_d[V];
        ldv<V>(a.ap_v + q, ov_v);
        if (!a.raw) ldv<V>(a.ap_d + q, ov_d);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (over >> j & 1u) {
            vout[j] = ov_v[j];
            if (!a.raw) ndis[j] = ov_d[j];
          }
        }
      }
    }
    stc<V>(a.out_v + e, vout);
    if (!a.raw) {
      stc<V>(a.out_delta + e, delta);
      if (RING) stc<V>(a.out_dis + e, ndis);
    }
  }
}

// 4 where the env axis divides by 4 and every view and array is aligned
// to 4 values where the kernel reads or writes 4 of them at once, and a
// view's strides keep it so; else 1
static int width(const CarFollowArgs& a) {
  if (a.d[3] % 4) return 1;
  auto al = [](const void* p, int size) {
    return !p || ((uintptr_t)p % (4 * size)) == 0;
  };
  bool ok = true;
  for (int k = 0; k < N_IN; ++k) {
    const View& v = a.in[k];
    if (v.p && v.st[3])
      ok = ok && al(v.p, v.is_bool ? 1 : 4) && v.st[0] % 4 == 0 &&
           v.st[1] % 4 == 0 && v.st[2] % 4 == 0;
  }
  ok = ok && al(a.out_v, 4) && al(a.out_delta, 4) && al(a.out_red, 1) &&
       al(a.tpl, 4) && al(a.lead_tpl, 4) && al(a.r_dis, 4) &&
       al(a.r_spd, 4) && al(a.r_tpl, 4) && al(a.r_n, 4) &&
       al(a.out_dis, 4) && al(a.r_nxt, 4) && al(a.r_last, 1) &&
       al(a.ap_v, 4) && al(a.ap_d, 4) && al(a.ap_rel, 1) && al(a.s0, 4);
  return ok ? 4 : 1;
}

template <bool YIELD, bool TPL, int RING>
static void launch(const CarFollowArgs& a, int V, cudaStream_t st) {
  const int threads = 256;
  const int NC = a.d[1] * a.d[2] * a.d[3];
  const unsigned blocks = (unsigned)((NC / V + threads - 1) / threads);
  if (V == 4)
    car_follow_kernel<YIELD, TPL, RING, 4><<<blocks, threads, 0, st>>>(a);
  else
    car_follow_kernel<YIELD, TPL, RING, 1><<<blocks, threads, 0, st>>>(a);
}

// the view reads p as the call's full contiguous array (each dimension
// of more than one element at its row-major stride)
static bool reads_full(const View& v, const void* p, const int d[4]) {
  if (!p || v.p != p) return false;
  int st = 1;
  for (int k = 3; k >= 0; --k) {
    if (d[k] > 1 && v.st[k] != st) return false;
    st *= d[k];
  }
  return true;
}

extern "C" int car_follow(const CarFollowArgs* args, void* stream) {
  CarFollowArgs a = *args;
  const long long n = (long long)a.d[0] * a.d[1] * a.d[2] * a.d[3];
  if (n == 0) return 0;
  if (n >= (1LL << 31) || a.mode < 1 || a.mode > 3) return -1;
  if (a.tpl && (!a.table || a.TP < 1)) return -1;
  if (a.with_yield && a.mode != 2) return -1;
  if (a.ring) {
    if (!(a.mode & 2) || !a.r_dis || !a.r_spd || !a.r_n || !a.len_row ||
        (a.tpl && !a.r_tpl) || (!a.raw && !a.out_dis) ||
        (a.ring == 1 && (!a.r_nxt || !a.r_last || !a.in_inv || !a.ap_v ||
                         !a.ap_rel || (!a.raw && !a.ap_d))) ||
        (a.ring == 2 && (!a.s0 || a.with_yield)) ||
        (a.ring != 1 && a.ring != 2))
      return -1;
  } else if (a.tpl && (a.mode & 2) && !a.lead_tpl) {
    return -1;
  }
  // the same IEEE single-precision operations as on the card (no
  // multiply-add among them to contract)
  a.U = derive(a.maxspd, a.turnspd, a.upa, a.una, a.yld, a.maxneg, a.mingap,
               a.headway, a.maxpos, a.lead_len, a.dt);
  a.hb = 0.5f * a.dt;
  a.hbb = a.hb * a.hb;
  a.spd_ring = a.ring && reads_full(a.in[IN_SPEED], a.r_spd, a.d);
  a.dls_ring = a.ring && reads_full(a.in[IN_DLS], a.r_dis, a.d);
  const int V = width(a);
  cudaStream_t st = (cudaStream_t)stream;
  const bool tpl = a.tpl != nullptr, y = a.with_yield != 0;
  if (a.ring == 1) {
    if (tpl) y ? launch<true, true, 1>(a, V, st)
               : launch<false, true, 1>(a, V, st);
    else y ? launch<true, false, 1>(a, V, st)
           : launch<false, false, 1>(a, V, st);
  } else if (a.ring == 2) {
    tpl ? launch<false, true, 2>(a, V, st)
        : launch<false, false, 2>(a, V, st);
  } else if (tpl) {
    y ? launch<true, true, 0>(a, V, st) : launch<false, true, 0>(a, V, st);
  } else {
    y ? launch<true, false, 0>(a, V, st)
      : launch<false, false, 0>(a, V, st);
  }
  return (int)cudaGetLastError();
}
