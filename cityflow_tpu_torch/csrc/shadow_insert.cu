// G15 shadow_insert: LaneChange::insertShadow (reference
// lanechange.cpp:71-102) of gen-1 lane change for B envs at once: each
// env's first MS changers in slot order put a shadow into its first MS
// free slots in slot order.
//
// Replaces the shadow insert of plan_lane_change in cityflow_tpu/core/
// lanechange.py (:228-291), which the TPU runs as two size-MS nonzeros
// (the changers, the free slots) and one drop-mode scatter per SimState
// leaf (about 40), one more for the real -> shadow link. Here, in one
// call (G11 spawn_slots' pattern):
//   1. one block per env compacts its changers and its free slots (each
//      thread a contiguous chunk, the chunk counts scanned in shared
//      memory), keeps the first MS of each in order and pairs them: the
//      (real, shadow slot) pairs, the env's overflow flag and its
//      seq_counter + 1 (every env, every call);
//   2. one thread per (env, slot) writes every per-slot leaf of the new
//      state: a shadow slot its real's row with the set values (kind
//      K_*: the target lane, 2^30 + uid, uid | 2^30, the env's ticket,
//      the real's slot, a constant), a real its partner link, every
//      other slot a copy of its old values. The step never writes its
//      input state, so every leaf is a new tensor either way; one launch
//      writes all of them.
// The kernel moves bytes and computes no float, so the same code serves
// float64 (exact mode) and float32 (fast mode): a leaf is its width in
// bytes.
//
// Bound: bytes. The state is read once and written once (about 180 bytes
// a slot in float32); the scan reads the change and active flags once
// more.
#include "gen1.cuh"

using namespace gen1;

constexpr int MAX_LEAVES = 40;
enum { K_COPY, K_CONST, K_DRV, K_PRIORITY, K_UID, K_SEQ, K_PARTNER };
constexpr int SHADOW_BIT = 1 << 30;
constexpr int OV_SLOTS_ = 1;

struct ShadowArgs {
  const uint8_t* do_change;  // (B, V) G7's decision
  const uint8_t* active;     // (B, V) before the insert
  const int* target;         // (B, V) G7's target lane
  const int* uid;            // (B, V)
  const int* seq;            // (B,) seq_counter before the step
  const int* overflow;       // (B,)
  int* pairs;                // (B, 2, MS) scratch: reals, then their slots
  int* seq_out;              // (B,)
  int* overflow_out;         // (B,)
  const void* src[MAX_LEAVES];   // each leaf (B, V, ...) in and out
  void* dst[MAX_LEAVES];
  long long width[MAX_LEAVES];   // bytes per slot
  long long kind[MAX_LEAVES];    // K_*
  long long cbits[MAX_LEAVES];   // K_CONST: the value's bits
  long long B, V, MS, nleaf, fp32;
};

__global__ void shadow_pairs(const ShadowArgs a) {
  __shared__ int sh[1024];
  const long long b = blockIdx.y;
  int* real = a.pairs + b * 2 * a.MS;
  int* slot = real + a.MS;
  block_first_n(a.do_change + b * a.V, true, a.V, a.MS, real, sh);
  block_first_n(a.active + b * a.V, false, a.V, a.MS, slot, sh);
  if (threadIdx.x == 0) {
    int ov = 0;
    for (long long k = 0; k < a.MS; ++k) {
      bool ok = real[k] >= 0 && slot[k] >= 0;
      ov |= real[k] >= 0 && slot[k] < 0;
      if (!ok) real[k] = slot[k] = -1;
    }
    a.seq_out[b] = a.seq[b] + 1;
    a.overflow_out[b] = a.overflow[b] | (ov ? OV_SLOTS_ : 0);
  }
}

__global__ void shadow_fill(const ShadowArgs a) {
  const long long b = blockIdx.y;
  const int* real = a.pairs + b * 2 * a.MS;
  const int* slot = real + a.MS;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    // v is the shadow of real[k], or the real of slot[j]; never both (a
    // real is active, a shadow's slot was free)
    long long k = -1, j = -1;
    for (long long i = 0; i < a.MS; ++i) {
      if (slot[i] == v) k = i;
      if (real[i] == v) j = i;
    }
    const long long me = b * a.V + v;
    const long long from = k >= 0 ? b * a.V + real[k] : me;
    for (long long i = 0; i < a.nleaf; ++i) {
      const long long w = a.width[i];
      char* d = (char*)a.dst[i] + me * w;
      const int kind = (int)a.kind[i];
      if (k < 0) {
        if (kind == K_PARTNER && j >= 0) {
          *(int*)d = slot[j];   // the real -> shadow link
        } else {
          copy_bytes(d, (const char*)a.src[i] + me * w, w);
        }
        continue;
      }
      switch (kind) {
        case K_COPY:
          copy_bytes(d, (const char*)a.src[i] + from * w, w);
          break;
        case K_DRV: *(int*)d = a.target[from]; break;
        case K_PRIORITY: *(int*)d = SHADOW_BIT + a.uid[from]; break;
        case K_UID: *(int*)d = a.uid[from] | SHADOW_BIT; break;
        case K_SEQ: *(int*)d = a.seq[b]; break;
        case K_PARTNER: *(int*)d = real[k]; break;
        default: copy_bytes(d, (const char*)&a.cbits[i], w);
      }
    }
  }
}

extern "C" int shadow_insert(const ShadowArgs* args, void* stream) {
  const ShadowArgs& a = *args;
  if (a.V == 0 || a.B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  shadow_pairs<<<dim3(1, (unsigned)a.B), 1024, 0, st>>>(a);
  const int threads = 256;
  shadow_fill<<<dim3(grid_blocks(a.V, threads), (unsigned)a.B), threads, 0,
                st>>>(a);
  return (int)cudaGetLastError();
}
