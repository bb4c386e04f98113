// G11 spawn_slots: Flow::nextStep + Engine::planRoute's valid path
// (reference flow.cpp:6-22, engine.cpp:450-470) for B envs at once: each
// env's due spawn rows go into its first free slots in slot order.
//
// Replaces spawn_vehicles in cityflow_tpu/core/step.py (:329-396), which
// the TPU runs as a dynamic_slice of the spawn table, a size-MS nonzero
// over ~active and one drop-mode scatter per SimState leaf (about 40).
// Two forms, one C entry each:
//
// spawn_slots, the copying form (the step's caller keeps its state: the
// Engine, core/step.step with donate=False), two launches:
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
//      values. The leaves are new tensors; one launch writes all of them.
//   Bound: bytes. The state is read once and written once (about 160
//   bytes a slot in float32); the scan reads the active flags once more.
//
// spawn_slots_inplace, the in-place form (the caller donates its state:
// the batched entries), one launch, a block per env:
//   1. tile by tile (256 threads x W flags, W = 16 with 16-byte loads
//      where the flags are aligned, else 1) each thread takes its free
//      slots (~active) as a bit mask, a block scan ranks them, and the
//      slots of rank < MS go to the env's list; the walk stops once MS
//      are found, so it reads the flags only up to the MS-th free slot;
//   2. the due rows are matched with the list as in the copying form;
//   3. the block's threads take the (leaf, row) pairs, consecutive rows of
//      a leaf on consecutive threads, and write each due row's value into
//      its target slot of each per-slot leaf in place; then the env's
//      cursor and overflow, in place. Nothing else of the pool is touched.
//   The leaf descriptors are staged in shared memory by an unrolled loop,
//   so no run-time index reaches the parameter struct (no stack frame).
//   Every value is read before a barrier that precedes its write: the
//   flags in step 1, the cursor, step and overflow before step 1.
//   Bound: bytes. The flags up to each env's MS-th free slot, the env's
//   MS spawn rows and their flow parameters, the written rows of every
//   leaf, the per-env scalars.
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

// ---- the in-place form -----------------------------------------------------

constexpr int SP_THREADS = 256;
constexpr int SP_WARPS = SP_THREADS / 32;

struct SpawnLeaf {
  char* p;            // (B, V, ...) the leaf, written in place
  int width;          // bytes a slot
  int kind;           // K_*
  long long cbits;    // K_CONST: the value's bits
};

struct SpawnInArgs {
  SpawnLeaf leaf[MAX_LEAVES];
  const int* step;          // (B,)
  int* cursor;              // (B,) in place
  int* overflow;            // (B,) in place
  const uint8_t* active;    // (B, V) before the spawn (also a leaf)
  const int* t_step;        // (n,) the spawn table, shared
  const int* t_flow;
  const int* t_priority;
  const int* t_first_drv;
  const int* t_route;
  const void* flow_params;  // (NF, NP) T
  const void* interval;     // () T
  int* tgt;                 // (B, MS) scratch: the free slots, then each
                            // row's slot (-1 none)
  int B, V, MS, n, NF, NP, nleaf, fp32;
};

template <typename T, int W>
__global__ void __launch_bounds__(SP_THREADS)
spawn_inplace(const SpawnInArgs a) {
  __shared__ SpawnLeaf sl[MAX_LEAVES];
  __shared__ int wsum[SP_WARPS];
  const int b = blockIdx.x, t = threadIdx.x;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < MAX_LEAVES; ++i)
      if (i < a.nleaf) sl[i] = a.leaf[i];
  }
  // plain loads: cursor and overflow are written at the end, active by
  // step 3
  const int cur0 = a.cursor[b], ov0 = a.overflow[b], stp = a.step[b];
  const int top = a.n - a.MS;
  const int start = cur0 < 0 ? 0 : (cur0 > top ? top : cur0);
  int* tgt = a.tgt + (long long)b * a.MS;
  // 1. the env's first MS free slots, in slot order
  const uint8_t* ac = a.active + (long long)b * a.V;
  int run = 0;                          // the same in every thread
  for (int t0 = 0; t0 < a.V && run < a.MS; t0 += SP_THREADS * W) {
    const int s0 = t0 + t * W;
    unsigned m = 0;
    if (s0 < a.V) {
      if (W == 16) {                    // V is a multiple of 16 here
        const uint4 f = *(const uint4*)(ac + s0);
        m = byte_bits(~f.x) | byte_bits(~f.y) << 4 | byte_bits(~f.z) << 8 |
            byte_bits(~f.w) << 12;
      } else {
        m = ac[s0] == 0;
      }
    }
    int tot;
    int r = run + block_scan<SP_THREADS>(__popc(m), &tot, wsum);
    for (; m && r < a.MS; m &= m - 1) tgt[r++] = s0 + __ffs(m) - 1;
    run += tot;
  }
  const int nfree = min(run, a.MS);
  __syncthreads();
  // 2. the due rows (a prefix of the window) matched with the free slots
  int nwant = 0, ov = 0;
  for (int k = t; k < a.MS; k += SP_THREADS) {
    const bool want = a.t_step[start + k] == stp;
    nwant += want;
    ov |= want && k >= nfree;
    tgt[k] = want && k < nfree ? tgt[k] : -1;
  }
  int tot_want, tot_ov;
  block_scan<SP_THREADS>(nwant, &tot_want, wsum);
  block_scan<SP_THREADS>(ov, &tot_ov, wsum);   // ends in a barrier
  // 3. each due row into its slot of every leaf
  const T* fpar = (const T*)a.flow_params;
  const T tin = *(const T*)a.interval;
  const long long base = (long long)b * a.V;
  for (int p = t; p < a.nleaf * a.MS; p += SP_THREADS) {
    const int i = p / a.MS, k = p - i * a.MS;
    const int slot = tgt[k];
    if (slot < 0) continue;
    const SpawnLeaf& L = sl[i];
    char* d = L.p + (base + slot) * L.width;
    const int row = start + k;
    const T* fp = fpar + clampll(a.t_flow[row], 0, a.NF - 1) * a.NP;
    switch (L.kind) {
      case K_SPEED: *(T*)d = fp[0]; break;
      case K_DRV: *(int*)d = a.t_first_drv[row]; break;
      case K_ROUTE: *(int*)d = a.t_route[row]; break;
      case K_ENTER: *(T*)d = T(stp) * tin; break;
      case K_PRIORITY: *(int*)d = a.t_priority[row]; break;
      case K_UID: *(int*)d = cur0 + k; break;
      case K_PARAMS:
        for (int c = 0; c < a.NP; ++c) ((T*)d)[c] = fp[c];
        break;
      default: copy_row(d, (const char*)&L.cbits, L.width);
    }
  }
  if (t == 0) {
    a.cursor[b] = cur0 + tot_want;
    a.overflow[b] = ov0 | (tot_ov ? OV_SLOTS_ : 0);
  }
}

extern "C" int spawn_slots_inplace(const SpawnInArgs* args, void* stream) {
  const SpawnInArgs& a = *args;
  if (a.V == 0 || a.B == 0) return 0;
  if (a.nleaf > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = a.V % 16 == 0 && (uintptr_t)a.active % 16 == 0;
  const dim3 grid((unsigned)a.B);
  if (a.fp32 && vec)
    spawn_inplace<float, 16><<<grid, SP_THREADS, 0, st>>>(a);
  else if (a.fp32)
    spawn_inplace<float, 1><<<grid, SP_THREADS, 0, st>>>(a);
  else if (vec)
    spawn_inplace<double, 16><<<grid, SP_THREADS, 0, st>>>(a);
  else
    spawn_inplace<double, 1><<<grid, SP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
