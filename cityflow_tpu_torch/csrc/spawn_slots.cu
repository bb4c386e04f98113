// G11 spawn_slots: Flow::nextStep + Engine::planRoute's valid path
// (reference flow.cpp:6-22, engine.cpp:450-470) for B envs at once: each
// env's due spawn rows go into its first free slots in slot order.
//
// Replaces spawn_vehicles in cityflow_tpu/core/step.py (:329-396), which
// the TPU runs as a dynamic_slice of the spawn table, a size-MS nonzero
// over ~active and one drop-mode scatter per SimState leaf (about 40).
// Here, in one call:
//   1. one block per env scans the free flags (each thread a contiguous
//      chunk, the chunk counts scanned in shared memory), keeps the first
//      MS free slots in order, and matches them with the env's due rows
//      (the rows from its cursor, clamped so MS rows fit, whose step is
//      the env's step): the target slot of each row, the new cursor and
//      the OV_SLOTS flag;
//   2. one thread per (env, slot) writes every per-slot leaf of the new
//      state: a target slot its row's values (the row's drivable, route,
//      priority and flow parameters, uid cursor + k, step * interval, the
//      leaf's empty value elsewhere), every other slot a copy of its old
//      values. The step never writes its input state, so the leaves are
//      new tensors either way; one launch writes all of them.
//
// Bound: bytes. The state is read once and written once (about 180 bytes
// a slot in float32); the scan reads the active flags once more.
#include "gen1.cuh"

using namespace gen1;

constexpr int MAX_LEAVES = 40;
enum { K_CONST, K_SPEED, K_DRV, K_ROUTE, K_ENTER, K_PRIORITY, K_UID,
       K_PARAMS };

struct SpawnArgs {
  const int* step;          // (B,)
  const int* cursor;        // (B,) rows of the spawn table consumed
  const int* overflow;      // (B,)
  const uint8_t* active;    // (B, V)
  const int* t_step;        // (n,) the spawn table, shared
  const int* t_flow;
  const int* t_priority;
  const int* t_first_drv;
  const int* t_route;
  const void* flow_params;  // (NF, NP) T
  const void* interval;     // () T
  int* tgt;                 // (B, MS) scratch: each row's slot, -1 none
  int* cursor_out;          // (B,)
  int* overflow_out;        // (B,)
  const void* src[MAX_LEAVES];   // each leaf (B, V, ...) in and out
  void* dst[MAX_LEAVES];
  long long width[MAX_LEAVES];   // bytes per slot
  long long kind[MAX_LEAVES];    // K_*
  long long cbits[MAX_LEAVES];   // K_CONST: the value's bits
  long long B, V, MS, n, NF, NP, nleaf, fp32;
};

constexpr int OV_SLOTS_ = 1;

__global__ void spawn_free(const SpawnArgs a) {
  __shared__ int sh[1024];
  const long long b = blockIdx.y;
  const uint8_t* active = a.active + b * a.V;
  int* tgt = a.tgt + b * a.MS;
  block_first_n(active, false, a.V, a.MS, tgt, sh);
  if (threadIdx.x == 0) {
    long long start = a.cursor[b];
    long long top = a.n - a.MS;
    start = start < 0 ? 0 : (start > top ? top : start);
    int nwant = 0, ov = 0;
    for (long long k = 0; k < a.MS; ++k) {
      bool want = a.t_step[start + k] == a.step[b];
      int slot = want ? tgt[k] : -1;
      nwant += want;
      ov |= want && slot < 0;
      tgt[k] = slot;
    }
    a.cursor_out[b] = a.cursor[b] + nwant;
    a.overflow_out[b] = a.overflow[b] | (ov ? OV_SLOTS_ : 0);
  }
}

template <typename T>
__global__ void spawn_fill(const SpawnArgs a) {
  const long long b = blockIdx.y;
  const int* tgt = a.tgt + b * a.MS;
  long long start = a.cursor[b];
  long long top = a.n - a.MS;
  start = start < 0 ? 0 : (start > top ? top : start);
  const T* fpar = (const T*)a.flow_params;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    long long k = -1;
    for (long long j = 0; j < a.MS; ++j)
      if (tgt[j] == v) {
        k = j;
        break;
      }
    long long slot = b * a.V + v;
    for (long long i = 0; i < a.nleaf; ++i) {
      long long w = a.width[i];
      char* d = (char*)a.dst[i] + slot * w;
      if (k < 0) {
        copy_bytes(d, (const char*)a.src[i] + slot * w, w);
        continue;
      }
      long long row = start + k;
      const T* fp = fpar + clampll(a.t_flow[row], 0, a.NF - 1) * a.NP;
      switch (a.kind[i]) {
        case K_SPEED: *(T*)d = fp[0]; break;
        case K_DRV: *(int*)d = a.t_first_drv[row]; break;
        case K_ROUTE: *(int*)d = a.t_route[row]; break;
        case K_ENTER: *(T*)d = T(a.step[b]) * *(const T*)a.interval; break;
        case K_PRIORITY: *(int*)d = a.t_priority[row]; break;
        case K_UID: *(int*)d = a.cursor[b] + (int)k; break;
        case K_PARAMS:
          for (long long c = 0; c < a.NP; ++c) ((T*)d)[c] = fp[c];
          break;
        default: copy_bytes(d, (const char*)&a.cbits[i], w);
      }
    }
  }
}

extern "C" int spawn_slots(const SpawnArgs* args, void* stream) {
  const SpawnArgs& a = *args;
  if (a.V == 0 || a.B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  spawn_free<<<dim3(1, (unsigned)a.B), 1024, 0, st>>>(a);
  const int threads = 256;
  GEN1_LAUNCH(spawn_fill, a, dim3(grid_blocks(a.V, threads), (unsigned)a.B),
              threads, 0, st);
  return (int)cudaGetLastError();
}
