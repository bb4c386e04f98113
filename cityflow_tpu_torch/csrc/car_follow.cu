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

template <bool YIELD, bool TPL>
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
      if (a.mode & 2) {
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
    float gap = rd(a.in[IN_GAP], e);
    float lead_spd = rd(a.in[IN_LEAD_SPD], e);
    bool has_lead = rb(a.in[IN_HAS_LEAD], e);
    bool isr_rel = rb(a.in[IN_ISR_REL], e);
    float custom = rd(a.in[IN_CUSTOM], e);
    bool has_custom = rb(a.in[IN_HAS_CUSTOM], e);
    float drv_maxspd = rd(a.in[IN_DRV_MAXSPD], e);
    bool invalid = rb(a.in[IN_INVALID], e);
    float lane_left = rd(a.in[IN_LANE_LEFT], e);
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
    if (a.raw) {
      a.out_v[e] = v;
      continue;
    }
    bool neg = v < 0.0f;
    a.out_delta[e] = neg ? 0.5f * speed * speed / maxneg
                         : (speed + v) * dt / 2.0f;
    a.out_v[e] = neg ? 0.0f : v;
  }
}

extern "C" int car_follow(const CarFollowArgs* args, void* stream) {
  if (args->n == 0) return 0;
  int threads = 256;
  long long blocks = (args->n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (args->tpl) {
    if (!args->table || args->TP < 1 || ((args->mode & 2) && !args->lead_tpl))
      return -1;
    if (args->with_yield)
      car_follow_kernel<true, true><<<(unsigned)blocks, threads, 0, st>>>(*args);
    else
      car_follow_kernel<false, true><<<(unsigned)blocks, threads, 0, st>>>(*args);
  } else if (args->with_yield) {
    car_follow_kernel<true, false><<<(unsigned)blocks, threads, 0, st>>>(*args);
  } else {
    car_follow_kernel<false, false><<<(unsigned)blocks, threads, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}
