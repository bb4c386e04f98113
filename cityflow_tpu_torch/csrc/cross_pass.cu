// G4 cross_pass: Vehicle::getIntersectionRelatedSpeed's cross loop
// (reference vehicle.cpp:357-374) with Cross::canPass (roadnet.cpp:604-660)
// for every vehicle: the turn cap, the first cross it must yield at, the
// stop speed before it and the new blocker.
//
// Replaces the cross loop of get_action in cityflow_tpu/core/step.py
// (:682-751), which the TPU evaluates as (V, KC) slabs: ten row gathers of
// the foe tables, the decision tree on every slot, an argmax for the first
// failure. Here one thread owns one vehicle and walks its lanelink's KC
// crosses in distance order, reading each foe's terms from G3's own-side
// tables through lnk_cross_foe_pos, and stops at the first failure, so the
// (V, KC) intermediates never reach device memory.
//
// B envs at once: the env is blockIdx.y; at_env moves the per-vehicle
// arrays and G3's tables to that env's rows, the cross tables are shared.
//
// Bound: bytes. Per considered cross a thread reads the cross tables and
// 10 foe terms (about 40 bytes) and does ~100 double operations; per
// vehicle it reads its state and params and writes 4 values.
#include "gen1.cuh"

using namespace gen1;

struct CrossPassArgs {
  const int* the_ll;         // (V,) the lanelink whose crosses apply, -1
  const void* dls;           // (V,) T distance along it (negative: before)
  const void* speed;         // (V,) T
  const void* params;        // (V, NP) T
  const int* ent;            // (V,) enter_ll_time
  const int* pri;            // (V,) priority
  const uint8_t* next_turn;  // (V,) the next drivable is a turning link
  const uint8_t* blk_ok;     // (V,) running & isr_related & !red_stop
  const void* cd;            // (LL, KC) T cross distance
  const uint8_t* cvalid;     // (LL, KC)
  const int* foetype;        // (LL, KC)
  const int* foe_pos;        // (LL, KC) flat own-side index of the foe
  const int* ll_type;        // (LL,)
  const uint8_t* ll_is_turn; // (LL,)
  const uint8_t* o_exists;   // (LL * KC,) G3's own-side tables
  const uint8_t* o_yield;
  const uint8_t* o_cleared;
  const uint8_t* o_cyc;
  const uint8_t* o_dpos;
  const void* o_dist;        // T
  const int* o_reach;
  const int* o_ent;
  const int* o_pri;
  const int* o_idx;
  const void* interval;      // () T
  void* v_isr;               // (V,) T
  uint8_t* any_fail;         // (V,)
  void* ff_d;                // (V,) T
  int* new_blocker;          // (V,)
  long long B, V, LL, KC, NP, fp32;
};

// the arguments of env b: the per-env arrays moved to that env's rows
__device__ CrossPassArgs at_env(CrossPassArgs a, long long b) {
  long long fs = a.fp32 ? 4 : 8, V = a.V, E = a.LL * a.KC;
  a.the_ll += b * V;
  a.dls = (const char*)a.dls + b * V * fs;
  a.speed = (const char*)a.speed + b * V * fs;
  a.params = (const char*)a.params + b * V * a.NP * fs;
  a.ent += b * V;
  a.pri += b * V;
  a.next_turn += b * V;
  a.blk_ok += b * V;
  a.o_exists += b * E;
  a.o_yield += b * E;
  a.o_cleared += b * E;
  a.o_cyc += b * E;
  a.o_dpos += b * E;
  a.o_dist = (const char*)a.o_dist + b * E * fs;
  a.o_reach += b * E;
  a.o_ent += b * E;
  a.o_pri += b * E;
  a.o_idx += b * E;
  a.v_isr = (char*)a.v_isr + b * V * fs;
  a.any_fail += b * V;
  a.ff_d = (char*)a.ff_d + b * V * fs;
  a.new_blocker += b * V;
  return a;
}

template <typename T>
__global__ void cross_pass_kernel(const CrossPassArgs a0) {
  const CrossPassArgs a = at_env(a0, blockIdx.y);
  const T* dls_ = (const T*)a.dls;
  const T* speed_ = (const T*)a.speed;
  const T* P = (const T*)a.params;
  const T* cd = (const T*)a.cd;
  const T* o_dist = (const T*)a.o_dist;
  const T dt = *(const T*)a.interval;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    const T* p = P + v * a.NP;
    T speed = speed_[v], dls = dls_[v];
    T turnspd = p[P_TURNSPEED], maxspd = p[P_MAXSPEED];
    T v_isr = maxspd;
    if (a.next_turn[v]) v_isr = tmin(v_isr, turnspd);
    int ll = a.the_ll[v];
    long long safe = clampll(ll, 0, a.LL - 1);
    int t1 = a.ll_type[safe];
    T target = a.ll_is_turn[safe] ? turnspd : maxspd;
    int my_ent = a.ent[v], my_pri = a.pri[v];
    long long first = -1;
    for (long long k = 0; ll >= 0 && k < a.KC; ++k) {
      long long tk = safe * a.KC + k;
      T d_onl = cd[tk];
      if (!a.cvalid[tk] || !(d_onl >= dls)) continue;
      long long fp = a.foe_pos[tk];
      T d1 = d_onl - dls;
      bool self_yield = can_yield(speed, p[P_MAXNEGACC], p[P_YIELD],
                                  p[P_LEN], d1);
      int sr = reach_steps(speed, d1, target, p[P_USUALPOSACC], dt);
      int fr = a.o_reach[fp];
      T d2 = o_dist[fp];
      int foe_ent = a.o_ent[fp];
      int same_rank_y =
          (fr > sr) ? -1
          : (fr < sr) ? 1
          : (my_ent == foe_ent)
              ? ((d1 == d2) ? ((my_pri > a.o_pri[fp]) ? -1 : 1)
                            : ((d1 < d2) ? -1 : 1))
              : ((my_ent < foe_ent) ? -1 : 1);
      bool foe_dpos = a.o_dpos[fp] != 0;
      bool foe_cleared = a.o_cleared[fp] != 0;
      int t_eq = foe_dpos ? same_rank_y : (foe_cleared ? -1 : 1);
      int t_lt_pre = foe_dpos ? ((fr > sr) ? -1 : 0) : (foe_cleared ? -1 : 0);
      int t_lt = (t_lt_pre == 0) ? 1 : t_lt_pre;
      int t2 = a.foetype[tk];
      int y = (t1 > t2) ? -1 : ((t1 < t2) ? t_lt : t_eq);
      if (!a.o_yield[fp]) y = 1;
      if (y == 1 && a.o_cyc[fp]) y = -1;
      bool passes = !a.o_exists[fp] || !self_yield || (y == -1);
      if (!passes) {
        first = k;
        break;
      }
    }
    bool any = first >= 0;
    long long tf = safe * a.KC + (any ? first : 0);
    T ffd = cd[tf];
    if (any) {
      T stop = stop_before_speed(speed, p[P_USUALPOSACC], p[P_USUALNEGACC],
                                 ffd - dls - p[P_YIELD], dt);
      v_isr = ref_min(v_isr, stop);
    }
    ((T*)a.v_isr)[v] = v_isr;
    a.any_fail[v] = any;
    ((T*)a.ff_d)[v] = ffd;
    a.new_blocker[v] =
        (any && a.blk_ok[v]) ? a.o_idx[a.foe_pos[tf]] : -1;
  }
}

extern "C" int cross_pass(const CrossPassArgs* args, void* stream) {
  const CrossPassArgs a = *args;
  if (a.V == 0 || a.B == 0) return 0;
  const int threads = 128;
  GEN1_LAUNCH(cross_pass_kernel, a,
              dim3(grid_blocks(a.V, threads), (unsigned)a.B), threads, 0,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
