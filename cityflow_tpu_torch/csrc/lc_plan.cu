// G7 lc_plan: planLaneChange for gen-1 lane change (reference
// SimpleLaneChange, lanechange.cpp:23-60, 151-220; vehicle.cpp:391-401),
// in four modes on one argument block:
//
//   signal   one thread per slot: makeSignal (the 3 s cooldown, the last
//            30 m of the lane, the expected-gap gates), the reachability
//            of each neighbour lane through the route, the target choice
//            by estimated gap, the target leader and follower (with no
//            leader on the target lane, the strict-min scan over the rear
//            vehicles of its outgoing lanelinks) and the two gaps
//   receive  sendSignal / receiveSignal: per receiver the highest sender
//            priority (int32 atomicMax from -2^31), then the largest
//            sender slot among the senders of that priority (a second
//            atomicMax keyed on the matching priority); target leaders and
//            target followers kept apart. Max is order-free, so the result
//            does not depend on the order of the atomics
//   decide   per slot: the signal it keeps (lc_recv), gap validity and
//            do_change
//   yield    per slot: yieldSpeed of a signal receiver (lanechange.cpp:
//            186-206), 100 otherwise; read by getAction
//
// Replaces plan_lane_change (cityflow_tpu/core/lanechange.py:108-226)
// and yield_speed (:294-318), which the TPU runs as (V,) slabs with
// clipped gathers and drop-row scatter-max passes. Every output is
// written for every slot, as there. The float formulas keep the JAX
// package's operation order.
//
// Bound: bytes. Per slot about 30 field reads (several through an index),
// the route entries of two lanes and k_out rear vehicles; a few outputs.
#include "gen1.cuh"

using namespace gen1;

struct LcPlanArgs {
  // slot state (V,)
  const uint8_t* running;
  const uint8_t* is_shadow;
  const uint8_t* lc_changing;
  const void* lc_last_t;     // T
  const int* drv;
  const void* dis;           // T
  const void* speed;         // T
  const void* gap;           // T
  const void* params;        // (V, NP) T
  const int* route;
  const int* route_pos;
  const int* lc_target;
  const int* priority;
  const int* step;           // () engine step
  // G6's neighbours (V,)
  const int* outer_lane;
  const int* inner_lane;
  const int* outer_leader;
  const int* outer_follower;
  const int* inner_leader;
  const int* inner_follower;
  // tables
  const void* drv_len;       // (D,) T
  const int* lane_out;       // (L, KO)
  const int* lane_local;     // (L,)
  const int* ll_end;         // (LL,)
  const int* route_len;      // (NR,)
  const int* route_next_ll;  // (NR, RLEN, MAXLPR)
  const int* last_of;        // (D,) G1's rear vehicle per drivable
  const void* interval;      // () T
  // signal outputs, read by receive and decide (V,)
  uint8_t* has_signal;
  int* target;
  int* direction;
  uint8_t* plan;
  int* tleader;
  int* tfollower;
  void* lgap;                // T
  void* fgap;                // T
  // receive outputs (V,): best priority and sender slot per role
  int* best_l;
  int* best_f;
  int* slot_l;
  int* slot_f;
  // decide outputs (V,)
  int* lc_recv;
  uint8_t* do_change;
  // yield: lc_recv, lc_fgap, lc_tleader, lc_tfollower of the state in,
  // the speed cap out
  const int* y_recv;
  const void* y_fgap;        // T
  const int* y_tleader;
  const int* y_tfollower;
  void* yield_v;             // T
  long long V, L, D, KO, NR, RLEN, MAXLPR, NP, fp32;
};

constexpr int INT32_MIN_ = -2147483647 - 1;

template <typename T>
__device__ __forceinline__ bool reachable(const LcPlanArgs& a, int lane,
                                          int route, int pos) {
  // onLastRoad() || router.getNextDrivable(lane) (lanechange.cpp:163,172)
  int np;
  int nxt = chain_next(a.route_next_ll, a.lane_local, a.ll_end, a.L, a.D,
                       a.NR, a.RLEN, a.MAXLPR, route, pos,
                       lane < a.L ? lane : -1, &np);
  int rl = a.route_len[clampll(route, 0, a.NR - 1)];
  return pos >= rl - 1 || nxt >= 0;
}

template <typename T>
__device__ __forceinline__ T estimate_gap(const LcPlanArgs& a, int leader,
                                          int lane, T dis_v) {
  // SimpleLaneChange::estimateGap (lanechange.cpp:215-220)
  const T* dis = (const T*)a.dis;
  const T* P = (const T*)a.params;
  if (leader < 0) return ((const T*)a.drv_len)[clampll(lane, 0, a.D - 1)] -
                         dis_v;
  long long l = clampll(leader, 0, a.V - 1);
  return dis[l] - dis_v - P[l * a.NP + P_LEN];
}

template <typename T>
__global__ void signal_kernel(const LcPlanArgs a) {
  const T* dis = (const T*)a.dis;
  const T* P = (const T*)a.params;
  const T* drv_len = (const T*)a.drv_len;
  const T dt = *(const T*)a.interval;
  const T now = T(*a.step) * dt;
  const T INF = T(INFINITY);
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    const T* p = P + v * a.NP;
    const T len = p[P_LEN];
    const T dis_v = dis[v];
    const int d = a.drv[v];
    const bool run = a.running[v], real = !a.is_shadow[v];
    const bool changing = a.lc_changing[v];
    const bool on_lane = run && d >= 0 && d < a.L;
    const int route = a.route[v], pos = a.route_pos[v];
    // makeSignal (lanechange.cpp:151-184)
    bool past_cool = now - ((const T*)a.lc_last_t)[v] >= T(3);
    bool mk = run && real && !changing && past_cool;
    T lane_left = drv_len[clampll(d, 0, a.D - 1)] - dis_v;
    bool gap_ok = on_lane && lane_left >= T(30);
    T cur_est = ((const T*)a.gap)[v];
    T expected = T(2) * len + T(4) * dt * p[P_MAXSPEED];
    bool want = mk && gap_ok && !(cur_est > expected) &&
                !(cur_est < T(1.5) * len);
    int outer = a.outer_lane[v], inner = a.inner_lane[v];
    bool outer_ok = want && outer < a.L && reachable<T>(a, outer, route, pos);
    T outer_est = outer_ok ? estimate_gap<T>(a, a.outer_leader[v], outer,
                                             dis_v)
                           : T(0);
    int target = (outer_ok && outer_est > cur_est + len) ? outer : -1;
    bool inner_ok = want && inner < a.L && reachable<T>(a, inner, route, pos);
    if (inner_ok) {
      T inner_est = estimate_gap<T>(a, a.inner_leader[v], inner, dis_v);
      if (inner_est > cur_est + len && inner_est > outer_est) target = inner;
    }
    // a changing vehicle keeps last step's signal (clearSignal returns)
    if (changing) target = a.lc_target[v];
    bool has = mk || changing;
    int dirn = target < 0 ? 0
               : (target == d + 1 ? 1 : (target == d - 1 ? -1 : 0));
    // planChange (lanechange.cpp:23-25)
    bool plan = ((has && target >= 0 && target != d) || changing) && run &&
                real;
    // the target's leader and follower (lanechange.cpp:27-60)
    bool is_outer = target == outer;
    int tl = is_outer ? a.outer_leader[v] : a.inner_leader[v];
    int tf = is_outer ? a.outer_follower[v] : a.inner_follower[v];
    T lg;
    if (tl >= 0) {
      long long l = clampll(tl, 0, a.V - 1);
      lg = dis[l] - dis_v - P[l * a.NP + P_LEN];
    } else {
      lg = INF;
    }
    // no leader on the target lane: the rear vehicles of its outgoing
    // lanelinks (lanechange.cpp:33-47)
    const T rest = lane_left;
    const bool no_tl = tl < 0;
    if (no_tl) lg = rest;
    T best = INF;
    long long ts = clampll(target, 0, a.L - 1);
    for (long long k = 0; k < a.KO; ++k) {
      int ol = a.lane_out[ts * a.KO + k];
      int cand = ol >= 0 ? a.last_of[clampll(ol, 0, a.D - 1)] : -1;
      long long cs = clampll(cand, 0, a.V - 1);
      T cgap = dis[cs] + rest;
      T clen = P[cs * a.NP + P_LEN];
      bool better = no_tl && cand >= 0 && cgap < best;
      if (better && cgap < clen) {
        tl = cand;
        lg = rest - (clen - cgap);
      }
      if (better) best = cgap;
    }
    T fg;
    if (tf >= 0) {
      fg = dis_v - dis[clampll(tf, 0, a.V - 1)] - len;
    } else {
      fg = INF;
    }
    a.has_signal[v] = has;
    a.target[v] = target;
    a.direction[v] = dirn;
    a.plan[v] = plan;
    a.tleader[v] = tl;
    a.tfollower[v] = tf;
    ((T*)a.lgap)[v] = lg;
    ((T*)a.fgap)[v] = fg;
  }
}

// receive, pass 1: the highest priority among the senders of each
// receiver (best_* start at -2^31)
__global__ void receive_best_kernel(const LcPlanArgs a) {
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    if (!(a.plan[v] && a.has_signal[v])) continue;
    int pri = a.priority[v];
    int tl = a.tleader[v], tf = a.tfollower[v];
    if (tl >= 0) atomicMax(a.best_l + tl, pri);
    if (tf >= 0) atomicMax(a.best_f + tf, pri);
  }
}

// receive, pass 2: the largest sender slot of that priority (slot_* start
// at -1)
__global__ void receive_slot_kernel(const LcPlanArgs a) {
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    if (!(a.plan[v] && a.has_signal[v])) continue;
    int pri = a.priority[v];
    int tl = a.tleader[v], tf = a.tfollower[v];
    if (tl >= 0 && a.best_l[tl] == pri) atomicMax(a.slot_l + tl, (int)v);
    if (tf >= 0 && a.best_f[tf] == pri) atomicMax(a.slot_f + tf, (int)v);
  }
}

template <typename T>
__global__ void decide_kernel(const LcPlanArgs a) {
  const T* speed = (const T*)a.speed;
  const T* P = (const T*)a.params;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    int bl = a.best_l[v], bf = a.best_f[v];
    int best_pri = bl > bf ? bl : bf;
    int src = bl >= bf ? a.slot_l[v] : a.slot_f[v];
    bool has = a.has_signal[v];
    bool changing = a.lc_changing[v];
    bool can_recv = a.running[v] && !changing &&
                    !(has && a.priority[v] >= best_pri) &&
                    best_pri > INT32_MIN_;
    int recv = can_recv ? src : -1;
    // gap validity (engine.cpp:792-820, lanechange.cpp:62-69)
    T s = speed[v];
    T min_brake = T(0.5) * s * s / P[v * a.NP + P_MAXNEGACC];
    int tf = a.tfollower[v];
    T safe_before = T(0);
    if (tf >= 0) {
      long long f = clampll(tf, 0, a.V - 1);
      T fs = speed[f];
      safe_before = T(0.5) * fs * fs / P[f * a.NP + P_MAXNEGACC];
    }
    bool gap_valid = ((const T*)a.lgap)[v] >= min_brake &&
                     ((const T*)a.fgap)[v] >= safe_before;
    bool can_change = has && recv < 0;
    int d = a.drv[v];
    bool on_lane = a.running[v] && d >= 0 && d < a.L;
    a.lc_recv[v] = recv;
    a.do_change[v] = a.plan[v] && can_change && !changing && gap_valid &&
                     on_lane && a.target[v] >= 0;
  }
}

template <typename T>
__global__ void yield_kernel(const LcPlanArgs a) {
  const T* speed = (const T*)a.speed;
  const T* P = (const T*)a.params;
  const T dt = *(const T*)a.interval;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    int src = a.y_recv[v];
    long long ss = clampll(src, 0, a.V - 1);
    T src_speed = speed[ss];
    T src_maxneg = P[ss * a.NP + P_MAXNEGACC];
    T src_fgap = ((const T*)a.y_fgap)[ss];
    int src_tl = a.y_tleader[ss];
    int src_tf = a.y_tfollower[ss];
    long long fs = clampll(src_tf, 0, a.V - 1);
    T tfs = speed[fs];
    T src_safe = src_tf >= 0 ? T(0.5) * tfs * tfs / P[fs * a.NP + P_MAXNEGACC]
                             : T(0);
    T g = src_fgap - src_safe;
    T y = no_collision_speed(src_speed, src_maxneg, speed[v],
                             P[v * a.NP + P_MAXNEGACC], g, dt, T(0));
    y = y < T(0) ? T(100) : y;
    ((T*)a.yield_v)[v] = (src >= 0 && src_tl != (int)v) ? y : T(100);
  }
}

extern "C" int lc_plan(const LcPlanArgs* args, int mode, void* stream) {
  const LcPlanArgs a = *args;
  if (a.V == 0) return 0;
  const int threads = 128;
  const unsigned g = grid_blocks(a.V, threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      GEN1_LAUNCH(signal_kernel, a, g, threads, 0, s);
      break;
    case 1:
      receive_best_kernel<<<g, threads, 0, s>>>(a);
      receive_slot_kernel<<<g, threads, 0, s>>>(a);
      break;
    case 2:
      GEN1_LAUNCH(decide_kernel, a, g, threads, 0, s);
      break;
    case 3:
      GEN1_LAUNCH(yield_kernel, a, g, threads, 0, s);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
