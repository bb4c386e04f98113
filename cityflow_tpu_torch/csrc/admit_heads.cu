// G12 admit_heads: Engine::handleWaiting (reference engine.cpp:502-516)
// up to the leader scan, for B envs at once: per lane the FIFO head of the
// waiting buffer, Lane::available (roadnet.cpp:428-436) and the admission.
//
// Replaces admit_waiting in cityflow_tpu/core/step.py (:398-443), which
// the TPU runs as two scatter-mins over the slot pool (the least waiting
// uid per lane, then the head's slot), a (L, 4) lane pack and one gather
// of it back to the slots. Here, in one call:
//   1. per (env, lane): min_uid = INT_MAX, head = V;
//   2. per waiting slot: atomicMin of its uid into its lane's min_uid;
//   3. per waiting slot holding its lane's min_uid: atomicMin of the slot
//      into the lane's head (integer atomics: order-free and exact);
//   4. per slot: is it the head, does its lane take it (the rear vehicle
//      of the previous step, its dis > len + the head's minGap), and the
//      new running / leader / gap / list ticket; the lanes' heads become
//      -1 where there is none.
//
// Bound: bytes. The slot flags, drivables and uids are read in steps 2-4,
// the per-slot outputs written once; the lane arrays are small.
#include "gen1.cuh"

using namespace gen1;

constexpr int INT_MAX_ = 2147483647;
constexpr int P_MINGAP = 7;

struct AdmitArgs {
  const uint8_t* active;    // (B, V)
  const uint8_t* running;   // (B, V)
  const int* drv;           // (B, V) a waiting vehicle's first lane
  const int* uid;           // (B, V)
  const void* dis;          // (B, V) T
  const void* params;       // (B, V, NP) T
  const int* leader;        // (B, V)
  const void* gap;          // (B, V) T
  const int* list_seq;      // (B, V)
  const int* last_of;       // (B, D) rear vehicles of the previous step
  const int* seq_counter;   // (B,)
  int* min_uid;             // (B, L) scratch
  int* head;                // (B, L) out: the head slot, -1 none
  uint8_t* running_out;     // (B, V)
  int* leader_out;          // (B, V)
  void* gap_out;            // (B, V) T
  int* list_seq_out;        // (B, V)
  uint8_t* need_scan;       // (B, V)
  long long B, V, D, L, NP, fp32;
};

__device__ __forceinline__ bool waiting(const AdmitArgs& a, long long s) {
  return a.active[s] && !a.running[s];
}

__global__ void admit_init(const AdmitArgs a) {
  const long long b = blockIdx.y;
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       l < a.L; l += (long long)gridDim.x * blockDim.x) {
    a.min_uid[b * a.L + l] = INT_MAX_;
    a.head[b * a.L + l] = (int)a.V;
  }
}

__global__ void admit_min_uid(const AdmitArgs a) {
  const long long b = blockIdx.y;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    long long s = b * a.V + v;
    int lane = a.drv[s];
    if (waiting(a, s) && lane >= 0 && lane < a.L)
      atomicMin(&a.min_uid[b * a.L + lane], a.uid[s]);
  }
}

__device__ __forceinline__ bool is_head(const AdmitArgs& a, long long b,
                                        long long s) {
  if (!waiting(a, s)) return false;
  long long lane = clampll(a.drv[s], 0, a.L - 1);
  return a.uid[s] == a.min_uid[b * a.L + lane];
}

__global__ void admit_head(const AdmitArgs a) {
  const long long b = blockIdx.y;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    long long s = b * a.V + v;
    int lane = a.drv[s];
    if (is_head(a, b, s) && lane >= 0 && lane < a.L)
      atomicMin(&a.head[b * a.L + lane], (int)v);
  }
}

template <typename T>
__global__ void admit_apply(const AdmitArgs a) {
  const long long b = blockIdx.y;
  const T* dis = (const T*)a.dis + b * a.V;
  const T* P = (const T*)a.params + b * a.V * a.NP;
  long long n = a.V > a.L ? a.V : a.L;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < n; v += (long long)gridDim.x * blockDim.x) {
    if (v < a.V) {
      long long s = b * a.V + v;
      bool head_v = is_head(a, b, s);
      // the lane pack of the vehicle's (clamped) lane
      long long lane = clampll(a.drv[s], 0, a.L - 1);
      int tail = a.last_of[b * a.D + lane];
      bool has_tail = tail >= 0;
      long long tc = clampll(tail, 0, a.V - 1);
      int hs = a.head[b * a.L + lane];
      long long hc = (hs < 0 || hs >= a.V) ? 0 : hs;
      T tdis = dis[tc], tlen = P[tc * a.NP + P_LEN];
      bool avail = !has_tail || (tdis > tlen + P[hc * a.NP + P_MINGAP]);
      bool admit = head_v && avail;
      bool follow = admit && has_tail;
      a.running_out[s] = a.running[s] || admit;
      a.leader_out[s] = follow ? tail : a.leader[s];
      ((T*)a.gap_out)[s] = follow ? (tdis - tlen) - dis[v]
                                  : ((const T*)a.gap)[s];
      a.list_seq_out[s] = admit ? a.seq_counter[b] : a.list_seq[s];
      a.need_scan[s] = admit && !has_tail;
    }
    // heads: V (none) -> -1; a reader above takes both as none
    if (v < a.L && a.head[b * a.L + v] >= a.V) a.head[b * a.L + v] = -1;
  }
}

extern "C" int admit_heads(const AdmitArgs* args, void* stream) {
  const AdmitArgs& a = *args;
  if (a.B == 0 || (a.V == 0 && a.L == 0)) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  unsigned by = (unsigned)a.B;
  long long n = a.V > a.L ? a.V : a.L;
  admit_init<<<dim3(grid_blocks(a.L, threads), by), threads, 0, st>>>(a);
  admit_min_uid<<<dim3(grid_blocks(a.V, threads), by), threads, 0, st>>>(a);
  admit_head<<<dim3(grid_blocks(a.V, threads), by), threads, 0, st>>>(a);
  GEN1_LAUNCH(admit_apply, a, dim3(grid_blocks(n, threads), by), threads, 0,
              st);
  return (int)cudaGetLastError();
}
