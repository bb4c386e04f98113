// G8 lc_commit: the lane-change parts of the gen-1 getAction and
// Vehicle::update, in two modes on one argument block:
//
//   tail    getAction's lane-change tail (engine.cpp:223-243): a shadow
//           about to leave its lane aborts; a changing real integrates its
//           lateral offset, max(0.2 v, 1) * interval a step towards
//           (w_cur + w_target) / 2, and finishes there unless its shadow
//           aborts in the same step; aborted shadows and finished reals
//           end this step
//   commit  lc_commit (lanechange.cpp:115-148, vehicle.cpp:378-381,
//           412-416): the shadow of a finishing real takes over its uid;
//           pairs whose partner was removed are unlinked (a changing real
//           whose shadow died reverts); the offset resets; clearSignal
//
// Replaces the lane-change branches of get_action (cityflow_tpu/core/
// step.py:807-826) and lc_commit (:909-942), which the TPU runs as (V,)
// slabs with gathers through the partner slot and a drop-row scatter of
// the promoted uids. Here one thread owns one slot and reads its partner's
// fields through the partner link, which the step keeps symmetric (a real
// and its shadow point at each other until both are unlinked in the same
// commit), so the scatter becomes a read.
//
// Bound: bytes. Per slot about ten fields and its partner's two or three.
#include "gen1.cuh"

using namespace gen1;

struct LcCommitArgs {
  // tail inputs (V,), the step's state and getAction's buffers
  const uint8_t* running;
  const uint8_t* is_shadow;
  const uint8_t* lc_changing;
  const int* partner;
  const int* drv;
  const int* buf_drv;        // drivable after this step's move
  const void* offset;        // T
  const void* new_speed;     // T
  const int* lc_dir;
  const int* lc_target;
  const uint8_t* end;        // the hop walk left the route
  const void* lane_width;    // (L,) T
  const void* interval;      // () T
  // tail outputs (V,)
  void* offset_out;          // T
  uint8_t* finish;
  uint8_t* abort_;
  uint8_t* end_out;
  // commit inputs (V,), the state after Vehicle::update
  const uint8_t* removed;
  const int* uid;
  const uint8_t* lc_finished;
  const uint8_t* lc_has_signal;
  const int* lc_last_dir;
  const uint8_t* c_finish;   // tail's finish
  const void* c_offset;      // T tail's offset
  // commit outputs (V,)
  int* uid_out;
  uint8_t* is_shadow_out;
  int* partner_out;
  void* offset_c_out;        // T
  uint8_t* lc_changing_out;
  uint8_t* lc_finished_out;
  int* lc_last_dir_out;
  int* lc_recv_out;
  uint8_t* lc_has_signal_out;
  int* lc_target_out;
  long long V, L, fp32;
};

__device__ __forceinline__ bool aborts(const LcCommitArgs& a, long long v) {
  // a shadow that moved to another drivable (engine.cpp:223-226)
  bool changed = a.running[v] && a.buf_drv[v] != a.drv[v];
  return a.running[v] && a.is_shadow[v] && changed && a.partner[v] >= 0;
}

template <typename T>
__global__ void tail_kernel(const LcCommitArgs a) {
  const T dt = *(const T*)a.interval;
  const T* lw = (const T*)a.lane_width;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    int p = a.partner[v];
    bool ab = aborts(a, v);
    bool chg = a.running[v] && a.lc_changing[v] && !a.is_shadow[v] && p >= 0;
    T dirn = T(a.lc_dir[v]);
    T off = ((const T*)a.offset)[v];
    T new_off = fabs(off + tmax(T(0.2) * ((const T*)a.new_speed)[v], T(1)) *
                               dt * dirn);
    T cur_w = lw[clampll(a.drv[v], 0, a.L - 1)];
    T tgt_w = lw[clampll(a.lc_target[v], 0, a.L - 1)];
    T max_off = (tgt_w + cur_w) / T(2);
    new_off = tmin(new_off, max_off);
    bool fin = chg && new_off >= max_off && !aborts(a, clampll(p, 0, a.V - 1));
    ((T*)a.offset_out)[v] = chg ? new_off * dirn : off;
    a.finish[v] = fin;
    a.abort_[v] = ab;
    a.end_out[v] = a.end[v] || ab || fin;
  }
}

template <typename T>
__global__ void commit_kernel(const LcCommitArgs a) {
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    int p = a.partner[v];
    long long ps = clampll(p, 0, a.V - 1);
    // the shadow of a finishing real (its partner, pointing back)
    bool promote = p >= 0 && a.c_finish[ps] && a.partner[ps] == (int)v;
    bool dead = p >= 0 && a.removed[ps];
    bool rm = a.removed[v];
    bool changing = a.lc_changing[v] && !(dead || rm);
    a.uid_out[v] = promote ? a.uid[ps] : a.uid[v];
    a.is_shadow_out[v] = (promote || dead) ? false : a.is_shadow[v];
    a.partner_out[v] = (promote || dead || rm) ? -1 : p;
    ((T*)a.offset_c_out)[v] =
        (dead || rm || promote) ? T(0) : ((const T*)a.c_offset)[v];
    a.lc_changing_out[v] = changing;
    a.lc_finished_out[v] = a.lc_finished[v] || a.c_finish[v];
    // clearSignal (lanechange.cpp:129-137)
    a.lc_last_dir_out[v] = a.running[v] ? a.lc_dir[v] : a.lc_last_dir[v];
    a.lc_recv_out[v] = -1;
    a.lc_has_signal_out[v] = changing ? a.lc_has_signal[v] : false;
    a.lc_target_out[v] = changing ? a.lc_target[v] : -1;
  }
}

extern "C" int lc_commit(const LcCommitArgs* args, int mode, void* stream) {
  const LcCommitArgs a = *args;
  if (a.V == 0) return 0;
  const int threads = 128;
  const unsigned g = grid_blocks(a.V, threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    GEN1_LAUNCH(tail_kernel, a, g, threads, 0, s);
  } else if (mode == 1) {
    GEN1_LAUNCH(commit_kernel, a, g, threads, 0, s);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
