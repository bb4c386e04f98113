// G12 admit_heads: Engine::handleWaiting (reference engine.cpp:502-516)
// up to the leader scan, for B envs at once: per lane the FIFO head of the
// waiting buffer, Lane::available (roadnet.cpp:428-436) and the admission.
//
// Replaces admit_waiting in cityflow_tpu/core/step.py (:398-443), which
// the TPU runs as two scatter-mins over the slot pool (the least waiting
// uid per lane, then the head's slot), a (L, 4) lane pack and one gather
// of it back to the slots. Here a memset and two kernels:
//   0. the (B, L, 2) scratch of 64-bit keys set to all ones ("none");
//   1. one pass over the slots, four flat slots a thread with 16-byte
//      loads and stores: each slot's unchanged outputs (running, leader,
//      gap, list ticket; need_scan false) written, and each waiting slot
//      (active, not running) in a lane offers the key (uid, slot) to its
//      lane by one 64-bit atomicMin (the uid sign-flipped so that unsigned
//      order is signed order): the key ends as the least uid and the
//      least slot holding it, the head. A slot whose atomicMin returns a
//      key of its own uid shares that uid with another waiting slot of the
//      lane: it offers (uid, ~greater slot of the two) to the lane's second
//      key. The least uid's greatest slot ends there: whichever of its
//      slots offers second finds the uid in place, as no smaller one comes;
//   2. one pass over the lanes: the head decoded and written (-1 none);
//      where there is one, the lane's rear vehicle of the previous step is
//      read and the strict `dis > len + the head's minGap` decides; an
//      available lane admits its head and, where the least uid repeats in
//      the lane (the second key holds it), every other waiting slot of
//      that uid up to the greatest, as the plain version's
//      `is_head = waiting & (uid == min_seq[lane])` does. Repeated uids
//      are not expected: a run takes one atomic a waiting slot.
// Each slot is read and written once; the lane pass reads the slots of
// the heads only.
//
// A waiting slot whose drv lies outside [0, L) offers nothing and is not
// admitted; tails and slots are clamped into [0, V) before a read, as the
// plain version's gathers clamp.
//
// Bound: bytes. Per slot its two flags, leader, ticket and gap in and
// running / leader / gap / ticket / scan flag out; drv and uid per waiting
// slot; per lane its key and head, and the rear vehicle and the head's
// parameters where the lane has a head.
#include "gen1.cuh"

using namespace gen1;

constexpr int P_MINGAP = 7;
constexpr unsigned long long KEY_NONE = ~0ULL;

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
  unsigned long long* keys; // (B, L, 2) scratch
  int* head;                // (B, L) out: the head slot, -1 none
  uint8_t* running_out;     // (B, V)
  int* leader_out;          // (B, V)
  void* gap_out;            // (B, V) T
  int* list_seq_out;        // (B, V)
  uint8_t* need_scan;       // (B, V)
  long long B, V, D, L, NP, fp32;
};

// flat slot i (env i / V) waiting in `lane`; keys[.., 0] the least
// (uid, slot), keys[.., 1] (uid, ~greatest slot) of uids offered twice
__device__ __forceinline__ void offer(const AdmitArgs& a, long long i,
                                      int lane, int uid) {
  if (lane < 0 || lane >= a.L) return;
  long long b = i / a.V;
  unsigned v = (unsigned)(i - b * a.V);
  unsigned long long hi = (unsigned long long)((unsigned)uid ^ 0x80000000u)
                          << 32;
  unsigned long long* k = a.keys + (b * a.L + lane) * 2;
  const unsigned long long old = atomicMin(k, hi | v);
  if (old != KEY_NONE && (old >> 32) == (hi >> 32)) {
    const unsigned o = (unsigned)old, m = o > v ? o : v;
    atomicMin(k + 1, hi | (0xFFFFFFFFu - m));
  }
}

template <typename T>
__device__ __forceinline__ void copy_slot(const AdmitArgs& a, long long i) {
  bool run = a.running[i];
  a.running_out[i] = run;
  a.need_scan[i] = 0;
  a.leader_out[i] = a.leader[i];
  a.list_seq_out[i] = a.list_seq[i];
  ((T*)a.gap_out)[i] = ((const T*)a.gap)[i];
  if (a.active[i] && !run) offer(a, i, a.drv[i], a.uid[i]);
}

// four T at 16-byte aligned src / dst
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *(float4*)dst = *(const float4*)src;
}

__device__ __forceinline__ void copy4(double* dst, const double* src) {
  ((double2*)dst)[0] = ((const double2*)src)[0];
  ((double2*)dst)[1] = ((const double2*)src)[1];
}

// pass 1; VEC: every per-slot array aligned for four slots at a time
template <typename T, bool VEC>
__global__ void admit_slots(const AdmitArgs a) {
  const long long n = a.B * a.V;
  const long long groups = (n + 3) / 4;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < groups; g += (long long)gridDim.x * blockDim.x) {
    const long long i0 = 4 * g;
    if (VEC && i0 + 4 <= n) {
      const unsigned act = *(const unsigned*)(a.active + i0);
      const unsigned run = *(const unsigned*)(a.running + i0);
      *(unsigned*)(a.running_out + i0) = run;
      *(unsigned*)(a.need_scan + i0) = 0u;
      *(int4*)(a.leader_out + i0) = *(const int4*)(a.leader + i0);
      *(int4*)(a.list_seq_out + i0) = *(const int4*)(a.list_seq + i0);
      copy4((T*)a.gap_out + i0, (const T*)a.gap + i0);
      // bools are bytes 0 / 1: a byte of `wait` is 1 where active, not
      // running
      const unsigned wait = act & ~run;
      if (wait) {
        const int4 d = *(const int4*)(a.drv + i0);
        const int4 u = *(const int4*)(a.uid + i0);
        if (wait & 0xFFu) offer(a, i0, d.x, u.x);
        if (wait & 0xFF00u) offer(a, i0 + 1, d.y, u.y);
        if (wait & 0xFF0000u) offer(a, i0 + 2, d.z, u.z);
        if (wait & 0xFF000000u) offer(a, i0 + 3, d.w, u.w);
      }
    } else {
      const long long end = i0 + 4 < n ? i0 + 4 : n;
      for (long long i = i0; i < end; ++i) copy_slot<T>(a, i);
    }
  }
}

// pass 2: one thread a lane of env blockIdx.y
template <typename T>
__global__ void admit_lanes(const AdmitArgs a) {
  const long long b = blockIdx.y;
  const T* dis = (const T*)a.dis + b * a.V;
  const T* P = (const T*)a.params + b * a.V * a.NP;
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       l < a.L; l += (long long)gridDim.x * blockDim.x) {
    const unsigned long long* k = a.keys + (b * a.L + l) * 2;
    const unsigned long long first = k[0];
    if (first == KEY_NONE) {
      a.head[b * a.L + l] = -1;
      continue;
    }
    const int hs = (int)(unsigned)first;
    a.head[b * a.L + l] = hs;
    const int tail = a.last_of[b * a.D + l];
    const bool has_tail = tail >= 0;
    const long long tc = clampll(tail, 0, a.V - 1);
    const T tdis = dis[tc], tlen = P[tc * a.NP + P_LEN];
    if (has_tail && !(tdis > tlen + P[(long long)hs * a.NP + P_MINGAP]))
      continue;
    // admit the head and the other waiting slots of its uid in the lane
    const int uid = (int)((unsigned)(first >> 32) ^ 0x80000000u);
    const unsigned long long dup = k[1];
    const long long last = dup != KEY_NONE && (dup >> 32) == (first >> 32)
                               ? 0xFFFFFFFFu - (unsigned)dup
                               : hs;
    const int seq = a.seq_counter[b];
    for (long long v = hs; v <= last; ++v) {
      const long long s = b * a.V + v;
      if (v != hs && !(a.active[s] && !a.running[s] && a.drv[s] == l &&
                       a.uid[s] == uid))
        continue;
      a.running_out[s] = 1;
      a.list_seq_out[s] = seq;
      a.need_scan[s] = !has_tail;
      if (has_tail) {
        // updateLeaderAndGap(tail): gap = tail.dis - tail.len - 0
        a.leader_out[s] = tail;
        ((T*)a.gap_out)[s] = (tdis - tlen) - dis[v];
      }
    }
  }
}

static bool aligned(const void* p, unsigned n) {
  return ((uintptr_t)p & (n - 1)) == 0;
}

extern "C" int admit_heads(const AdmitArgs* args, void* stream) {
  const AdmitArgs& a = *args;
  if (a.B == 0 || (a.V == 0 && a.L == 0)) return 0;
  if (a.B > 65535 || a.V > 0x7FFFFFFFLL) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (a.L > 0) {
    cudaError_t rc = cudaMemsetAsync(
        a.keys, 0xFF, (size_t)(a.B * a.L * 2) * sizeof(unsigned long long),
        st);
    if (rc != cudaSuccess) return (int)rc;
  }
  const bool vec = aligned(a.active, 4) && aligned(a.running, 4) &&
                   aligned(a.running_out, 4) && aligned(a.need_scan, 4) &&
                   aligned(a.drv, 16) && aligned(a.uid, 16) &&
                   aligned(a.leader, 16) && aligned(a.leader_out, 16) &&
                   aligned(a.list_seq, 16) && aligned(a.list_seq_out, 16) &&
                   aligned(a.gap, 16) && aligned(a.gap_out, 16);
  const long long groups = (a.B * a.V + 3) / 4;
  if (groups > 0) {
    const dim3 grid(grid_blocks(groups, threads));
    if (a.fp32) {
      if (vec)
        admit_slots<float, true><<<grid, threads, 0, st>>>(a);
      else
        admit_slots<float, false><<<grid, threads, 0, st>>>(a);
    } else {
      if (vec)
        admit_slots<double, true><<<grid, threads, 0, st>>>(a);
      else
        admit_slots<double, false><<<grid, threads, 0, st>>>(a);
    }
  }
  if (a.L > 0)
    GEN1_LAUNCH(admit_lanes, a,
                dim3(grid_blocks(a.L, threads), (unsigned)a.B), threads, 0,
                st);
  return (int)cudaGetLastError();
}
