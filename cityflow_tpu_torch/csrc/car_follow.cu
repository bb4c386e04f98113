// K3 car_follow: getIntersectionRelatedSpeed + Vehicle::getNextSpeed's
// min-rule, fused elementwise (reference vehicle.cpp:308-376).
//
// Replaces isr_speed and min_chain in cityflow_tpu/core/ring.py
// (:998-1092), applied on link rows, approach rows and lane rows
// (:1094-1369). Mode bit 1 runs isr_speed, bit 2 runs min_chain; with both,
// the intersection speed stays in a register. The lane-change mode is
// min_chain with the yieldSpeed input v_yield (:1081), raw on the
// lane-change path; it is its own instantiation (YIELD = true), so the
// one without it compiles to the same code as before.
//
// Every input is a (pointer, div, mod) view: element e of the output reads
// p[(e / div) % mod], so tables broadcast over slots and envs without being
// expanded in memory; a null pointer reads the scalar `val`.
//
// The template mode (non-uniform vehicle templates, :1001-1064) is its own
// instantiation (TPL = true): every element reads its vehicle's template
// index `tpl` and, for min_chain, its leader's `lead_tpl` (both of the
// output's full shape), and takes the parameters from the (TP, 12) table
// instead of the scalar arguments: its own maxSpeed, turnSpeed,
// usualPosAcc, usualNegAcc, yieldDistance, maxNegAcc, minGap, headwayTime,
// maxPosAcc, and the leader's maxNegAcc and usualNegAcc in the
// no-collision terms (vehicle.cpp:217, 229). An index outside [0, TP) reads
// zeros, like the JAX one-hot einsum (_PP, :270-297). The uniform
// instantiation keeps the scalar arguments and is unchanged.
//
// The ring-leader mode (ring = 1 lane rows, 2 link rows; :1094-1150 and
// :1301-1386) replaces the leader views the JAX step builds by shifting
// each ring one slot (a TPU shift plan) and the where-chains around them:
// element (s, n, b) reads its leader in slot s - 1 of the ring itself
// (distance 1e9, speed 0, no leader, template 0 at s = 0; has_lead =
// s - 1 < n), the gap as (lead_dis - lead_len) - dis in that order, and on
// lane rows lane_left = ln_len - dis and invalid = occupied & nxt < 0 &
// !last. On link rows slot 0's leader is the end-lane tail, read from the
// end-lane bundle `s0` (dis, speed, exists, template channels): its gap is
// ((lk_len - dis) + tail_dis) - tail_len. On lane rows the front slots
// s < AP of a lane with an in-lane (in_inv >= 0) whose approach row is
// relevant (ap_rel) take the approach result ap_v (and ap_d) instead. It
// also writes the new distance dis + delta (or ap_d) where not raw. Its
// own instantiation (RING = true): the other modes compile as before.
//
// Bound: bytes. About 12 inputs of 4 or 1 bytes and 2-3 outputs per element
// against ~80 float operations: well under the card's float rate.
#include "common.cuh"

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
  const void* p;
  long long div;
  long long mod;
  float val;
  int is_bool;
};

struct CarFollowArgs {
  View in[N_IN];
  float* out_v;         // isr only: v_isr; else the new speed (or raw v)
  float* out_delta;     // min_chain (not raw): distance increment
  uint8_t* out_red;     // isr only: red_stop
  long long n;
  int mode;             // 1 = isr, 2 = min_chain, 3 = both
  int raw;
  float maxspd, turnspd, upa, una, yld, maxneg, mingap, headway, maxpos, dt;
  int with_yield;       // 1: the lane-change mode (v_yield input)
  const int* tpl;       // template mode: (n,) own template index, else null
  const int* lead_tpl;  //   (n,) the leader's (min_chain)
  const float* table;   //   (TP, 12) template parameters
  int TP;
  // ring-leader mode (0 off, 1 lane rows, 2 link rows): rows (S, N, B)
  int ring;
  long long S, N, B;
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
  long long AP, ILG;
  // link rows: the end-lane bundle (CE, N, B), channels dis, speed,
  // exists, template
  const float* s0;
  int s0_dis, s0_spd, s0_ex, s0_tpl;
};

// parameter columns of the template table (compiler/net.py P_*)
enum {
  P_SPEED = 0, P_LEN, P_WIDTH, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC,
  P_USUALNEGACC, P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED,
  P_N
};

__device__ __forceinline__ float tparam(const CarFollowArgs& a, int t,
                                        int col) {
  return (t >= 0 && t < a.TP) ? __ldg(&a.table[t * P_N + col]) : 0.0f;
}

__device__ __forceinline__ float rd(const View& v, long long e) {
  if (!v.p) return v.val;
  long long i = (e / v.div) % v.mod;
  if (v.is_bool) return ((const uint8_t*)v.p)[i] ? 1.0f : 0.0f;
  return ((const float*)v.p)[i];
}

__device__ __forceinline__ bool rb(const View& v, long long e) {
  return rd(v, e) != 0.0f;
}

// the leader views of element e in the ring-leader mode
struct Lead {
  float gap, spd, lane_left;
  bool has, invalid;
  int tpl;
};

template <bool TPL>
__device__ __forceinline__ Lead ring_lead(const CarFollowArgs& a,
                                          long long e) {
  const long long row = a.N * a.B;
  const long long s = e / row;
  const long long r = e % row;            // (n, b)
  const long long nn = r / a.B;
  const float dis = a.r_dis[e];
  const int n_occ = a.r_n[r];
  Lead L;
  float lead_dis = 1e9f;
  L.spd = 0.0f;
  L.has = false;
  L.tpl = 0;
  if (s > 0) {
    lead_dis = a.r_dis[e - row];
    L.spd = a.r_spd[e - row];
    L.has = s - 1 < n_occ;
    if (TPL) L.tpl = a.r_tpl[e - row];
  } else if (a.ring == 2) {
    const float* s0 = a.s0;
    L.spd = s0[a.s0_spd * row + r];
    L.has = s0[a.s0_ex * row + r] > 0.5f;
    if (TPL) L.tpl = xla_f32_to_i32(s0[a.s0_tpl * row + r]);
  }
  const float lead_len =
      TPL ? tparam(a, L.tpl, P_LEN) : a.lead_len;
  L.gap = (lead_dis - lead_len) - dis;
  if (s == 0 && a.ring == 2 && L.has) {
    L.gap = ((a.len_row[nn] - dis) + a.s0[a.s0_dis * row + r]) - lead_len;
  }
  L.lane_left = 0.0f;
  L.invalid = false;
  if (a.ring == 1) {
    L.lane_left = a.len_row[nn] - dis;
    L.invalid = (s < n_occ) && a.r_nxt[e] < 0 && !a.r_last[e];
  }
  return L;
}

template <bool YIELD, bool TPL, bool RING>
__global__ void car_follow_kernel(const CarFollowArgs a) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < a.n; e += (long long)gridDim.x * blockDim.x) {
    float maxspd = a.maxspd, turnspd = a.turnspd, upa = a.upa, una = a.una;
    float yld = a.yld, maxneg = a.maxneg, mingap = a.mingap;
    float headway = a.headway, maxpos = a.maxpos;
    float l_maxneg = a.maxneg, l_una = a.una;
    if (TPL) {
      int t = a.tpl[e];
      maxspd = tparam(a, t, P_MAXSPEED);
      turnspd = tparam(a, t, P_TURNSPEED);
      upa = tparam(a, t, P_USUALPOSACC);
      una = tparam(a, t, P_USUALNEGACC);
      yld = tparam(a, t, P_YIELD);
      maxneg = tparam(a, t, P_MAXNEGACC);
      mingap = tparam(a, t, P_MINGAP);
      headway = tparam(a, t, P_HEADWAY);
      maxpos = tparam(a, t, P_MAXPOSACC);
      if ((a.mode & 2) && !RING) {
        int lt = a.lead_tpl[e];
        l_maxneg = tparam(a, lt, P_MAXNEGACC);
        l_una = tparam(a, lt, P_USUALNEGACC);
      }
    }
    float speed = rd(a.in[IN_SPEED], e);
    float v_isr = 0.0f;
    bool red_stop = false;
    if (a.mode & 1) {
      // isr_speed
      float dls = rd(a.in[IN_DLS], e);
      float lane_left = rd(a.in[IN_ISR_LANE_LEFT], e);
      bool app = rb(a.in[IN_APP], e);
      v_isr = maxspd;
      if (app && rb(a.in[IN_TURN], e)) v_isr = tmin(v_isr, turnspd);
      if (rb(a.in[IN_ANY_FAIL], e)) {
        float ff_d = rd(a.in[IN_FF_D], e);
        float v_stop = stop_before_speed(speed, upa, una,
                                         ff_d - dls - yld, a.dt);
        v_isr = ref_min(v_isr, v_stop);
      }
      bool red = app && (!rb(a.in[IN_AVAIL], e) || !rb(a.in[IN_CAN_ENTER], e));
      float min_brake = 0.5f * speed * speed / maxneg;
      red_stop = red && !(min_brake > lane_left);
      if (red_stop) {
        v_isr = ref_min(maxspd, stop_before_speed(speed, upa, una,
                                                    lane_left, a.dt));
      }
      if (!(a.mode & 2)) {
        a.out_v[e] = v_isr;
        a.out_red[e] = red_stop;
        continue;
      }
    } else {
      v_isr = rd(a.in[IN_V_ISR], e);
    }
    // min_chain
    float gap, lead_spd, lane_left;
    bool has_lead, invalid;
    if (RING) {
      const Lead L = ring_lead<TPL>(a, e);
      gap = L.gap;
      lead_spd = L.spd;
      has_lead = L.has;
      if (a.ring == 1) {
        lane_left = L.lane_left;
        invalid = L.invalid;
      } else {
        lane_left = rd(a.in[IN_LANE_LEFT], e);
        invalid = rb(a.in[IN_INVALID], e);
      }
      if (TPL) {
        l_maxneg = tparam(a, L.tpl, P_MAXNEGACC);
        l_una = tparam(a, L.tpl, P_USUALNEGACC);
      }
    } else {
      gap = rd(a.in[IN_GAP], e);
      lead_spd = rd(a.in[IN_LEAD_SPD], e);
      has_lead = rb(a.in[IN_HAS_LEAD], e);
      invalid = rb(a.in[IN_INVALID], e);
      lane_left = rd(a.in[IN_LANE_LEFT], e);
    }
    bool isr_rel = rb(a.in[IN_ISR_REL], e);
    float custom = rd(a.in[IN_CUSTOM], e);
    bool has_custom = rb(a.in[IN_HAS_CUSTOM], e);
    float drv_maxspd = rd(a.in[IN_DRV_MAXSPD], e);
    float dt = a.dt;
    float v_hard = no_collision_speed(lead_spd, l_maxneg, speed, maxneg,
                                      gap, dt, 0.0f);
    float assume_decel = (speed > lead_spd) ? speed - lead_spd : 0.0f;
    float v_soft = no_collision_speed(lead_spd, l_una, speed, una, gap, dt,
                                      mingap);
    float v_headway = ((gap + (lead_spd + assume_decel / 2.0f) * dt -
                        speed * dt / 2.0f) / (headway + dt / 2.0f));
    float v_plain = tmin(tmin(v_hard, v_soft), v_headway);
    float v_cust = tmin(custom, v_hard);
    float v_lead = has_custom ? v_cust : v_plain;
    float v_nolead = has_custom ? custom : maxspd;
    float v_cf = has_lead ? v_lead : v_nolead;
    float v = tmin(maxspd, speed + maxpos * dt);
    v = tmin(v, drv_maxspd);
    v = tmin(v, v_cf);
    if (isr_rel) v = tmin(v, v_isr);
    if (YIELD) v = tmin(v, rd(a.in[IN_V_YIELD], e));
    if (invalid) {
      float v_inv = no_collision_speed(0.0f, 1.0f, speed, maxneg, lane_left,
                                       dt, mingap);
      v = tmin(v, v_inv);
    }
    v = tmax(v, speed - maxneg * dt);
    // ring lane rows: a front slot whose approach row is relevant takes
    // the approach result
    bool over = false;
    float ov_v = 0.0f, ov_d = 0.0f;
    if (RING && a.ring == 1) {
      const long long row = a.N * a.B;
      const long long s = e / row;
      if (s < a.AP) {
        const long long b = e % a.B;
        const int i = a.in_inv[(e % row) / a.B];
        if (i >= 0) {
          const long long q = (s * a.ILG + i) * a.B + b;
          over = a.ap_rel[q] != 0;
          ov_v = a.ap_v[q];
          if (!a.raw) ov_d = a.ap_d[q];
        }
      }
    }
    if (a.raw) {
      a.out_v[e] = over ? ov_v : v;
      continue;
    }
    bool neg = v < 0.0f;
    const float delta = neg ? 0.5f * speed * speed / maxneg
                            : (speed + v) * dt / 2.0f;
    a.out_delta[e] = delta;
    a.out_v[e] = over ? ov_v : (neg ? 0.0f : v);
    if (RING) a.out_dis[e] = over ? ov_d : a.r_dis[e] + delta;
  }
}

extern "C" int car_follow(const CarFollowArgs* args, void* stream) {
  if (args->n == 0) return 0;
  int threads = 256;
  long long blocks = (args->n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)blocks;
  if (args->ring) {
    const CarFollowArgs& a = *args;
    if (!(a.mode & 2) || !a.r_dis || !a.r_spd || !a.r_n || !a.len_row ||
        a.S * a.N * a.B != a.n || (a.tpl && !a.r_tpl) ||
        (!a.raw && !a.out_dis) ||
        (a.ring == 1 && (!a.r_nxt || !a.r_last || !a.in_inv || !a.ap_v ||
                         !a.ap_rel || (!a.raw && !a.ap_d))) ||
        (a.ring == 2 && !a.s0) || (a.ring != 1 && a.ring != 2))
      return -1;
    if (a.tpl) {
      if (!a.table || a.TP < 1) return -1;
      if (a.with_yield)
        car_follow_kernel<true, true, true><<<g, threads, 0, st>>>(a);
      else
        car_follow_kernel<false, true, true><<<g, threads, 0, st>>>(a);
    } else if (a.with_yield) {
      car_follow_kernel<true, false, true><<<g, threads, 0, st>>>(a);
    } else {
      car_follow_kernel<false, false, true><<<g, threads, 0, st>>>(a);
    }
  } else if (args->tpl) {
    if (!args->table || args->TP < 1 || ((args->mode & 2) && !args->lead_tpl))
      return -1;
    if (args->with_yield)
      car_follow_kernel<true, true, false><<<g, threads, 0, st>>>(*args);
    else
      car_follow_kernel<false, true, false><<<g, threads, 0, st>>>(*args);
  } else if (args->with_yield) {
    car_follow_kernel<true, false, false><<<g, threads, 0, st>>>(*args);
  } else {
    car_follow_kernel<false, false, false><<<g, threads, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}
