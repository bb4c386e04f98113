// G5 hist_window: Lane::updateHistory (reference roadnet.cpp:900-915) for
// every lane: this call's (vehicle count, speed sum), the 241-row ring's
// row at hist_t % 241 and the window sums over the ring.
//
// Replaces update_history in cityflow_tpu/core/step.py (:970-999), which
// the TPU computes as two scatter-adds over the V-slot pool into (L + 1,)
// rows (the order of the adds left to XLA) and two dynamic slices of the
// ring. Here one thread owns one lane and sums its vehicles in one fixed
// order, G1's per-drivable order walked from the rear (last_of) along the
// leader chain, so the speed sums are the same on every run; there is no
// float atomic. The outputs are either the inputs themselves (in place,
// where the caller donates its state) or new sums and a copy of each ring
// made by the wrapper; either way a thread reads its (env, lane)'s old
// ring row and sums before it writes the new ones at the same addresses,
// so the in-place form needs no other synchronisation.
//
// Bound: bytes. Per lane: its rear slot, then per vehicle its leader and
// speed; the old ring row and sums in, the new row and sums out (in
// float32, 4 + 32 bytes per lane and env, 8 per vehicle). The copying
// form also moves both rings once more (the wrapper's copies).
//
// B envs at once: the env is blockIdx.y, and at_env moves every per-env
// pointer (last_of, the slots, the rings, the sums, hist_t) to that env's
// rows. Each env takes its ring row from its own hist_t.
#include "gen1.cuh"

using namespace gen1;

struct HistWindowArgs {
  const int* last_of;       // (D,) rear vehicle per drivable (lanes first)
  const int* leader;        // (V,) the vehicle ahead on the same drivable
  const void* speed;        // (V,) T
  const void* ring_num;     // (HL1, L) T
  const void* ring_ssum;    // (HL1, L) T
  const void* hist_num;     // (L,) T window sums
  const void* hist_ssum;    // (L,) T
  const int* hist_t;        // () calls so far
  void* out_num;            // (L,) T new window sums
  void* out_ssum;           // (L,) T
  void* ring_num_out;       // (HL1, L) T ring_num or a copy; row slot written
  void* ring_ssum_out;      // (HL1, L) T
  long long B, L, D, HL1, V, fp32;
};

// the arguments of env b: the per-env arrays moved to that env's rows
__device__ HistWindowArgs at_env(HistWindowArgs a, long long b) {
  long long fs = a.fp32 ? 4 : 8;
  a.last_of += b * a.D;
  a.leader += b * a.V;
  a.speed = (const char*)a.speed + b * a.V * fs;
  a.ring_num = (const char*)a.ring_num + b * a.HL1 * a.L * fs;
  a.ring_ssum = (const char*)a.ring_ssum + b * a.HL1 * a.L * fs;
  a.hist_num = (const char*)a.hist_num + b * a.L * fs;
  a.hist_ssum = (const char*)a.hist_ssum + b * a.L * fs;
  a.hist_t += b;
  a.out_num = (char*)a.out_num + b * a.L * fs;
  a.out_ssum = (char*)a.out_ssum + b * a.L * fs;
  a.ring_num_out = (char*)a.ring_num_out + b * a.HL1 * a.L * fs;
  a.ring_ssum_out = (char*)a.ring_ssum_out + b * a.HL1 * a.L * fs;
  return a;
}

template <typename T>
__global__ void hist_window_kernel(const HistWindowArgs a0) {
  const HistWindowArgs a = at_env(a0, blockIdx.y);
  const T* speed = (const T*)a.speed;
  const long long t = *a.hist_t;
  const long long slot = t % a.HL1;
  const bool full = t >= a.HL1;
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       l < a.L; l += (long long)gridDim.x * blockDim.x) {
    T n = T(0), s = T(0);
    int guard = 0;
    for (int v = a.last_of[l]; v >= 0 && guard < a.V; v = a.leader[v]) {
      n = n + T(1);
      s = s + speed[v];
      ++guard;
    }
    const long long r = slot * a.L + l;
    T old_n = full ? ((const T*)a.ring_num)[r] : T(0);
    T old_s = full ? ((const T*)a.ring_ssum)[r] : T(0);
    ((T*)a.out_num)[l] = ((const T*)a.hist_num)[l] - old_n + n;
    ((T*)a.out_ssum)[l] = ((const T*)a.hist_ssum)[l] - old_s + s;
    ((T*)a.ring_num_out)[r] = n;
    ((T*)a.ring_ssum_out)[r] = s;
  }
}

extern "C" int hist_window(const HistWindowArgs* args, void* stream) {
  const HistWindowArgs a = *args;
  if (a.L == 0 || a.B == 0) return 0;
  const int threads = 128;
  GEN1_LAUNCH(hist_window_kernel, a,
              dim3(grid_blocks(a.L, threads), (unsigned)a.B), threads, 0,
              (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
