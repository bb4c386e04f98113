// O1 lane_stats: per-lane reductions over the occupied slots of a ring
// (the slots below n), one thread per (column, env).
//
// Replaces three TPU-shaped reductions of the JAX package, each a masked
// jnp.sum over the whole (SL, LNp) slab:
//   mode 0  lane_waiting_ring (cityflow_tpu/core/ring_observe.py:24-27):
//           the waiting count, speed < 0.1f (engine.cpp:641);
//   mode 1  _update_history (cityflow_tpu/core/ring.py:210-236): the
//           occupied speed sum and the rolling-window update. Per env the
//           ring row h_t % H is read (only once h_t >= H) and overwritten in
//           place; the window sums come out as (h - old) + cur, JAX's order;
//   mode 2  observations_ring (cityflow_tpu/core/ring_observe.py:115-130):
//           the waiting count, and now - enter summed over the occupied slots
//           of every lane and link column; a second kernel of this source
//           reduces those column sums per env in a fixed order (one block per
//           env, a strided pass then a shared-memory tree), lanes and links
//           apart, then adds them as JAX does.
// No float atomics: every sum has one order, the same from run to run.
//
// Bound: bytes. The speeds (or enter times) of the occupied slots, the
// counts, and the outputs; in mode 1 also one ring row per env read and
// written.
#include "common.cuh"

struct LaneStatsArgs {
  int mode;               // 0 waiting, 1 history, 2 observations
  const float* speed;     // (S, N, B) lane speeds (modes 0, 1)
  const int* n;           // (N, B) occupied slots per lane
  long long S, N, B;
  int* wait;              // (N, B) waiting counts (modes 0, 2)
  // mode 1
  float* ring_num;        // (H, N, B) per-step lane counts, row h_t % H
  float* ring_ssum;       // (H, N, B) per-step speed sums
  const float* h_num;     // (N, B) window sums in
  const float* h_ssum;
  float* h_num_out;       // (N, B) window sums out
  float* h_ssum_out;
  const int* h_t;         // (B,) updates so far
  long long H;
  // mode 2
  const float* enter;     // (S, N, B) lane enter times
  const float* k_enter;   // (SK, NK, B) link enter times
  const int* n_k;         // (NK, B)
  long long SK, NK;
  const float* now;       // (B,) step * interval
  float* part;            // (N + NK, B) per-column sums (scratch)
  float* inflight;        // (B,) out
};

__global__ void lane_stats_kernel(const LaneStatsArgs a) {
  long long cols = a.mode == 2 ? a.N + a.NK : a.N;
  long long total = cols * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long c = e / a.B;
    if (c >= a.N) {                       // mode 2: a link column
      long long k = c - a.N;
      int nk = a.n_k[k * a.B + b];
      float now = a.now[b];
      float s = 0.0f;
      for (long long t = 0; t < nk && t < a.SK; ++t)
        s += now - a.k_enter[(t * a.NK + k) * a.B + b];
      a.part[e] = s;
      continue;
    }
    int n = a.n[e];
    long long lim = n < a.S ? n : a.S;
    if (a.mode == 1) {
      float s = 0.0f;
      for (long long t = 0; t < lim; ++t) s += a.speed[(t * a.N + c) * a.B + b];
      float cur = (float)n;
      int ht = a.h_t[b];
      long long row = ((ht % a.H) + a.H) % a.H;
      long long f = (row * a.N + c) * a.B + b;
      bool full = ht >= a.H;
      float old_num = full ? a.ring_num[f] : 0.0f;
      float old_ssum = full ? a.ring_ssum[f] : 0.0f;
      a.h_num_out[e] = (a.h_num[e] - old_num) + cur;
      a.h_ssum_out[e] = (a.h_ssum[e] - old_ssum) + s;
      a.ring_num[f] = cur;
      a.ring_ssum[f] = s;
      continue;
    }
    int w = 0;
    float s = 0.0f;
    float now = a.mode == 2 ? a.now[b] : 0.0f;
    for (long long t = 0; t < lim; ++t) {
      long long f = (t * a.N + c) * a.B + b;
      w += a.speed[f] < 0.1f;
      if (a.mode == 2) s += now - a.enter[f];
    }
    a.wait[e] = w;
    if (a.mode == 2) a.part[e] = s;
  }
}

#define RED_THREADS 256

// inflight[b] = (sum of part[0:N, b]) + (sum of part[N:N+NK, b]), each sum
// in a fixed order: thread t adds columns t, t + 256, ... in turn, then a
// tree over the 256 partial sums.
__global__ void lane_stats_reduce(const LaneStatsArgs a) {
  __shared__ float sh[RED_THREADS];
  long long b = blockIdx.x;
  float tot[2];
  for (int part = 0; part < 2; ++part) {
    long long c0 = part == 0 ? 0 : a.N;
    long long c1 = part == 0 ? a.N : a.N + a.NK;
    float s = 0.0f;
    for (long long c = c0 + threadIdx.x; c < c1; c += RED_THREADS)
      s += a.part[c * a.B + b];
    sh[threadIdx.x] = s;
    __syncthreads();
    for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
      if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
      __syncthreads();
    }
    tot[part] = sh[0];
    __syncthreads();
  }
  if (threadIdx.x == 0) a.inflight[b] = tot[0] + tot[1];
}

extern "C" int lane_stats(const LaneStatsArgs* args, void* stream) {
  const LaneStatsArgs& a = *args;
  if (a.mode < 0 || a.mode > 2) return -1;
  long long cols = a.mode == 2 ? a.N + a.NK : a.N;
  long long total = cols * a.B;
  cudaStream_t s = (cudaStream_t)stream;
  if (total > 0) {
    int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 65535LL * 32) blocks = 65535LL * 32;
    lane_stats_kernel<<<(unsigned)blocks, threads, 0, s>>>(a);
  }
  if (a.mode == 2 && a.B > 0)
    lane_stats_reduce<<<(unsigned)a.B, RED_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
