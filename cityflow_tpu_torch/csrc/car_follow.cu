// K3 car_follow: getIntersectionRelatedSpeed + Vehicle::getNextSpeed's
// min-rule, fused elementwise (reference vehicle.cpp:308-376).
//
// Replaces isr_speed and min_chain in cityflow_tpu/core/ring.py
// (:998-1092), applied on link rows, approach rows and lane rows
// (:1094-1369). Mode bit 1 runs isr_speed, bit 2 runs min_chain; with both,
// the intersection speed stays in a register.
//
// Every input is a (pointer, div, mod) view: element e of the output reads
// p[(e / div) % mod], so tables broadcast over slots and envs without being
// expanded in memory; a null pointer reads the scalar `val`.
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
};

__device__ __forceinline__ float rd(const View& v, long long e) {
  if (!v.p) return v.val;
  long long i = (e / v.div) % v.mod;
  if (v.is_bool) return ((const uint8_t*)v.p)[i] ? 1.0f : 0.0f;
  return ((const float*)v.p)[i];
}

__device__ __forceinline__ bool rb(const View& v, long long e) {
  return rd(v, e) != 0.0f;
}

__global__ void car_follow_kernel(const CarFollowArgs a) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < a.n; e += (long long)gridDim.x * blockDim.x) {
    float speed = rd(a.in[IN_SPEED], e);
    float v_isr = 0.0f;
    bool red_stop = false;
    if (a.mode & 1) {
      // isr_speed
      float dls = rd(a.in[IN_DLS], e);
      float lane_left = rd(a.in[IN_ISR_LANE_LEFT], e);
      bool app = rb(a.in[IN_APP], e);
      v_isr = a.maxspd;
      if (app && rb(a.in[IN_TURN], e)) v_isr = tmin(v_isr, a.turnspd);
      if (rb(a.in[IN_ANY_FAIL], e)) {
        float ff_d = rd(a.in[IN_FF_D], e);
        float v_stop = stop_before_speed(speed, a.upa, a.una,
                                         ff_d - dls - a.yld, a.dt);
        v_isr = tmin(v_isr, v_stop);
      }
      bool red = app && (!rb(a.in[IN_AVAIL], e) || !rb(a.in[IN_CAN_ENTER], e));
      float min_brake = 0.5f * speed * speed / a.maxneg;
      red_stop = red && !(min_brake > lane_left);
      if (red_stop) {
        v_isr = tmin(a.maxspd, stop_before_speed(speed, a.upa, a.una,
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
    float v_hard = no_collision_speed(lead_spd, a.maxneg, speed, a.maxneg,
                                      gap, dt, 0.0f);
    float assume_decel = (speed > lead_spd) ? speed - lead_spd : 0.0f;
    float v_soft = no_collision_speed(lead_spd, a.una, speed, a.una, gap, dt,
                                      a.mingap);
    float v_headway = ((gap + (lead_spd + assume_decel / 2.0f) * dt -
                        speed * dt / 2.0f) / (a.headway + dt / 2.0f));
    float v_plain = tmin(tmin(v_hard, v_soft), v_headway);
    float v_cust = tmin(custom, v_hard);
    float v_lead = has_custom ? v_cust : v_plain;
    float v_nolead = has_custom ? custom : a.maxspd;
    float v_cf = has_lead ? v_lead : v_nolead;
    float v = tmin(a.maxspd, speed + a.maxpos * dt);
    v = tmin(v, drv_maxspd);
    v = tmin(v, v_cf);
    if (isr_rel) v = tmin(v, v_isr);
    if (invalid) {
      float v_inv = no_collision_speed(0.0f, 1.0f, speed, a.maxneg, lane_left,
                                       dt, a.mingap);
      v = tmin(v, v_inv);
    }
    v = tmax(v, speed - a.maxneg * dt);
    if (a.raw) {
      a.out_v[e] = v;
      continue;
    }
    bool neg = v < 0.0f;
    a.out_delta[e] = neg ? 0.5f * speed * speed / a.maxneg
                         : (speed + v) * dt / 2.0f;
    a.out_v[e] = neg ? 0.0f : v;
  }
}

extern "C" int car_follow(const CarFollowArgs* args, void* stream) {
  if (args->n == 0) return 0;
  int threads = 256;
  long long blocks = (args->n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  car_follow_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
