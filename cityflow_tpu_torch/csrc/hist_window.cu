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
// float atomic. The new ring is a copy of the old one made by the
// wrapper; the kernel writes its row `slot` and reads the old row first.
//
// Bound: bytes. Per lane: its rear slot, then per vehicle its leader and
// speed (12 bytes); the old ring row and sums in, the new row and sums
// out (64 bytes per lane).
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
  void* ring_num_out;       // (HL1, L) T copy of ring_num; row slot written
  void* ring_ssum_out;      // (HL1, L) T
  long long L, HL1, V, fp32;
};

template <typename T>
__global__ void hist_window_kernel(const HistWindowArgs a) {
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
  if (a.L == 0) return 0;
  const int threads = 128;
  GEN1_LAUNCH(hist_window_kernel, a, grid_blocks(a.L, threads), threads,
                                     0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
