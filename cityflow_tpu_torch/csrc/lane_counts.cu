// G13 lane_counts: the gen-1 observations' reductions over the slot pool
// (reference Engine::getLaneVehicleCount, getLaneWaitingVehicleCount,
// engine.cpp:628-648, and getAverageTravelTime's sums, :682-691) for B envs
// at once.
//
// Replaces lane_vehicle_count, lane_waiting_vehicle_count,
// drivable_vehicle_count and _avg_travel_time in
// cityflow_tpu/core/observe.py (:14-35, :60-67), which the TPU runs as
// drop-row scatter-adds of ones over the (L + 1) / (D + 1) bins and a
// masked sum. Here:
//   1. one thread per (env, slot): a running vehicle on a lane adds one to
//      its lane's count, and to the waiting count when its speed < 0.1;
//      with D, one to its drivable's count (int atomics: exact, order-free);
//   2. given the interval, one block per env: the in-flight sum of
//      step * interval - enter_time over the active slots (each thread a
//      strided share, then a fixed tree in shared memory, no float atomics:
//      the same bits on every run), and the running and active counts.
//
// Bound: bytes. Every slot's flags, drivable, speed and entry time are
// read (the last twice: once per pass); the outputs are small.
#include "gen1.cuh"

using namespace gen1;

struct CountArgs {
  const uint8_t* running;   // (B, V)
  const uint8_t* active;    // (B, V)
  const int* drv;           // (B, V)
  const void* speed;        // (B, V) T
  const void* enter_time;   // (B, V) T
  const int* step;          // (B,)
  const void* interval;     // () T, or null: no per-env sums
  int* lane_count;          // (B, L) zeroed
  int* lane_waiting;        // (B, L) zeroed
  int* drv_count;           // (B, D) zeroed, or null (D == 0)
  int* n_running;           // (B,) or null (no interval)
  int* n_active;            // (B,) or null
  void* inflight;           // (B,) T or null
  long long B, V, L, D, fp32;
};

template <typename T>
__global__ void count_slots(const CountArgs a) {
  const long long b = blockIdx.y;
  const T* speed = (const T*)a.speed + b * a.V;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    long long s = b * a.V + v;
    int d = a.drv[s];
    if (!a.running[s] || d < 0) continue;
    if (d < a.L) {
      atomicAdd(&a.lane_count[b * a.L + d], 1);
      if (speed[v] < T(0.1)) atomicAdd(&a.lane_waiting[b * a.L + d], 1);
    }
    if (a.drv_count != nullptr && d < a.D)
      atomicAdd(&a.drv_count[b * a.D + d], 1);
  }
}

template <typename T>
__global__ void count_env(const CountArgs a) {
  __shared__ __align__(8) unsigned char red_raw[1024 * sizeof(double)];
  __shared__ int shr[1024], sha[1024];
  T* red = (T*)red_raw;
  const long long b = blockIdx.y;
  const T* et = (const T*)a.enter_time + b * a.V;
  const T now = T(a.step[b]) * *(const T*)a.interval;
  const int t = threadIdx.x, nt = blockDim.x;
  T part = T(0);
  int nr = 0, na = 0;
  for (long long v = t; v < a.V; v += nt) {
    long long s = b * a.V + v;
    nr += a.running[s];
    if (a.active[s]) {
      part = part + (now - et[v]);
      ++na;
    }
  }
  red[t] = part;
  shr[t] = nr;
  sha[t] = na;
  __syncthreads();
  for (int o = nt / 2; o > 0; o >>= 1) {
    if (t < o) {
      red[t] = red[t] + red[t + o];
      shr[t] += shr[t + o];
      sha[t] += sha[t + o];
    }
    __syncthreads();
  }
  if (t == 0) {
    ((T*)a.inflight)[b] = red[0];
    a.n_running[b] = shr[0];
    a.n_active[b] = sha[0];
  }
}

extern "C" int lane_counts(const CountArgs* args, void* stream) {
  const CountArgs& a = *args;
  if (a.B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (a.V > 0)
    GEN1_LAUNCH(count_slots, a, dim3(grid_blocks(a.V, threads),
                                     (unsigned)a.B), threads, 0, st);
  if (a.interval != nullptr)
    GEN1_LAUNCH(count_env, a, dim3(1, (unsigned)a.B), 1024, 0, st);
  return (int)cudaGetLastError();
}
