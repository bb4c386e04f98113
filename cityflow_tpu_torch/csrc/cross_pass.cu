// G4 cross_pass: Vehicle::getIntersectionRelatedSpeed's cross loop
// (reference vehicle.cpp:357-374) with Cross::canPass (roadnet.cpp:604-660)
// for every vehicle: the turn cap, the first cross it must yield at, the
// stop speed before it and the new blocker.
//
// Replaces the cross loop of get_action in cityflow_tpu/core/step.py
// (:682-751), which the TPU evaluates as (V, KC) slabs: ten row gathers of
// the foe tables, the decision tree on every slot, an argmax for the first
// failure. Here a thread owns one vehicle and walks its lanelink's KC
// crosses in distance order, stopping at its first failure, so the
// (V, KC) intermediates never reach device memory. (A group of 4 threads
// a vehicle, each walking every 4th cross, the first failure the group's
// least index by shuffle, was timed A B B A against this form on the
// H100: 0.5088 against 0.3813 ms at B = 128, the groups' reads past a
// vehicle's first failure costing more than they hide; 0.0113 against
// 0.0211 ms at one env, where the card is 9-18% busy. This form was
// kept; PERF.md row 17d''.)
//
// What bounds it is the foe side: G3's own-side tables hold B x LL x KC
// entries per term (far more than L2 at B = 128), read through
// lnk_cross_foe_pos at scattered positions, a 32-byte sector for 1-4
// useful bytes. So each term is read only where the decision depends on
// it, in this order (canPass is `!exists || !self_yield || y == -1`):
//   1. the own lanelink's row: cvalid, then cd (cd >= dls: a NaN fails);
//   2. self_yield, from the vehicle's own registers: where it is false
//      the cross passes with no foe read;
//   3. o_exists (through foe_pos): where it is false the cross passes;
//   4. o_yield: where the foe cannot yield, y is 1 (step 9);
//   5. foetype: t1 > t2 passes;
//   6. o_dpos, then o_cleared where the foe is not past the cross;
//   7. only where it is, reach_steps (seven divisions and a square root)
//      and o_reach;
//   8. only on a reach tie with equal types, o_ent, then o_dist or o_pri;
//   9. where y is 1, o_cyc: a blocker cycle flips it to a pass.
// Every comparison is the plain version's, so NaN and -0.0 decide alike.
// The vehicle's seven parameter columns, speed and dls are read once into
// registers (canYield's brake distance once per vehicle: it does not
// depend on the cross), enter time and priority only on a reach tie, the
// foe's o_idx only at the first failure of a vehicle that may block.
//
// B envs at once: the env is blockIdx.y; the per-env offsets (b * V for
// the vehicles, b * LL * KC for G3's tables) are 32-bit, computed once
// per thread (the wrapper checks that B * V * NP and B * LL * KC fit); the
// cross tables are shared. Inputs are read through __ldg.
//
// Bound: bytes. Per vehicle its inputs and four outputs; per cross up to
// its first failure, cvalid and cd; per considered cross the foe terms
// the decision reads (the funnel above); o_idx at a blocking failure.
#include "gen1.cuh"

using namespace gen1;

constexpr int CP_THREADS = 256;

struct CrossPassArgs {
  const int* the_ll;         // (B, V) the lanelink whose crosses apply, -1
  const void* dls;           // (B, V) T distance along it (negative: before)
  const void* speed;         // (B, V) T
  const void* params;        // (B, V, NP) T
  const int* ent;            // (B, V) enter_ll_time
  const int* pri;            // (B, V) priority
  const uint8_t* next_turn;  // (B, V) the next drivable is a turning link
  const uint8_t* blk_ok;     // (B, V) running & isr_related & !red_stop
  const void* cd;            // (LL, KC) T cross distance
  const uint8_t* cvalid;     // (LL, KC)
  const int* foetype;        // (LL, KC)
  const int* foe_pos;        // (LL, KC) flat own-side index of the foe
  const int* ll_type;        // (LL,)
  const uint8_t* ll_is_turn; // (LL,)
  const uint8_t* o_exists;   // (B, LL * KC) G3's own-side tables
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
  void* v_isr;               // (B, V) T
  uint8_t* any_fail;         // (B, V)
  void* ff_d;                // (B, V) T
  int* new_blocker;          // (B, V)
  int B, V, LL, KC, NP, fp32;
};

// Does the vehicle pass the cross at tk (flat own-row index) of distance
// c >= dls? Cross::canPass, each foe term read where it decides.
template <typename T>
__device__ __forceinline__ bool passes(const CrossPassArgs& a, int tk, int eo,
                                       int vo, T d1, T min_brake, T yld,
                                       T len, T speed, T target, T upa,
                                       T dt, int t1) {
  // canYield(d1) of the vehicle itself (vehicle.cpp:284-287)
  if (!(((d1 > T(0)) && (min_brake < d1 - yld)) ||
        ((d1 < T(0)) && (d1 + len < T(0)))))
    return true;
  const int fp = eo + __ldg(a.foe_pos + tk);
  if (!__ldg(a.o_exists + fp)) return true;
  if (__ldg(a.o_yield + fp)) {
    const int t2 = __ldg(a.foetype + tk);
    if (t1 > t2) return true;
    bool pass;
    if (__ldg(a.o_dpos + fp)) {
      const int sr = reach_steps(speed, d1, target, upa, dt);
      const int fr = __ldg(a.o_reach + fp);
      if (fr != sr || t1 < t2) {
        pass = fr > sr;
      } else {
        const int me = __ldg(a.ent + vo), fe = __ldg(a.o_ent + fp);
        if (me != fe) {
          pass = me < fe;
        } else {
          const T d2 = __ldg((const T*)a.o_dist + fp);
          pass = (d1 == d2) ? (__ldg(a.pri + vo) > __ldg(a.o_pri + fp))
                            : (d1 < d2);
        }
      }
    } else {
      pass = __ldg(a.o_cleared + fp) != 0;
    }
    if (pass) return true;
  }
  // y == 1: a blocker cycle from the foe flips it to a pass
  return __ldg(a.o_cyc + fp) != 0;
}

template <typename T>
__global__ void __launch_bounds__(CP_THREADS)
cross_pass_kernel(const CrossPassArgs a) {
  const int v = (int)(blockIdx.x * CP_THREADS + threadIdx.x);
  if (v >= a.V) return;
  const int vo = (int)blockIdx.y * a.V + v;
  const int eo = (int)blockIdx.y * (a.LL * a.KC);
  const T* cd = (const T*)a.cd;
  const T* p = (const T*)a.params + vo * a.NP;
  const T speed = __ldg((const T*)a.speed + vo);
  const T dls = __ldg((const T*)a.dls + vo);
  const T len = __ldg(p + P_LEN), maxneg = __ldg(p + P_MAXNEGACC);
  const T upa = __ldg(p + P_USUALPOSACC), una = __ldg(p + P_USUALNEGACC);
  const T maxspd = __ldg(p + P_MAXSPEED), yld = __ldg(p + P_YIELD);
  const T turnspd = __ldg(p + P_TURNSPEED);
  const T dt = __ldg((const T*)a.interval);
  const int ll = __ldg(a.the_ll + vo);
  int row = 0, first = a.KC;            // KC: no failing cross
  if (ll >= 0) {
    const int safe = ll < a.LL ? ll : a.LL - 1;
    row = safe * a.KC;
    const int t1 = __ldg(a.ll_type + safe);
    const T target = __ldg(a.ll_is_turn + safe) ? turnspd : maxspd;
    const T min_brake = T(0.5) * speed * speed / maxneg;
    for (int k = 0; k < a.KC; ++k) {
      const int tk = row + k;
      if (!__ldg(a.cvalid + tk)) continue;
      const T c = __ldg(cd + tk);
      if (!(c >= dls)) continue;
      if (!passes<T>(a, tk, eo, vo, c - dls, min_brake, yld, len, speed,
                     target, upa, dt, t1)) {
        first = k;
        break;
      }
    }
  }
  T v_isr = maxspd;
  if (__ldg(a.next_turn + vo)) v_isr = tmin(v_isr, turnspd);
  const bool any = first < a.KC;
  const int tf = row + (any ? first : 0);
  const T ffd = __ldg(cd + tf);
  if (any)
    v_isr = ref_min(v_isr, stop_before_speed(speed, upa, una,
                                             ffd - dls - yld, dt));
  ((T*)a.v_isr)[vo] = v_isr;
  a.any_fail[vo] = any;
  ((T*)a.ff_d)[vo] = ffd;
  a.new_blocker[vo] = (any && __ldg(a.blk_ok + vo))
                          ? __ldg(a.o_idx + eo + __ldg(a.foe_pos + tf))
                          : -1;
}

extern "C" int cross_pass(const CrossPassArgs* args, void* stream) {
  const CrossPassArgs a = *args;
  if (a.V == 0 || a.B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((a.V + CP_THREADS - 1) / CP_THREADS),
                  (unsigned)a.B);
  if (a.fp32)
    cross_pass_kernel<float><<<grid, CP_THREADS, 0, st>>>(a);
  else
    cross_pass_kernel<double><<<grid, CP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
