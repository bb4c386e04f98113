// G15 shadow_insert: LaneChange::insertShadow (reference
// lanechange.cpp:71-102) of gen-1 lane change for B envs at once, IN
// PLACE: each env's first MS changers in slot order put a shadow into its
// first MS free slots in slot order.
//
// Replaces the shadow insert of plan_lane_change in cityflow_tpu/core/
// lanechange.py (:228-291), which the TPU runs as two size-MS nonzeros
// (the changers, the free slots) and one drop-mode scatter per SimState
// leaf (about 40), one more for the real -> shadow link, out of place.
// Only the pairs' rows change, so here only they are written, in two
// launches:
//   1. shadow_scan<W>: a block per (chunk of slots, env), NCH chunks an
//      env (so that one env is not one SM). Tile by tile (256 threads x W
//      slots, W = 16 with 16-byte loads where the flags are aligned, else
//      1) each thread counts its changers (do_change) and free slots
//      (~active) as bit masks, a block scan of the counts ranks them, and
//      each writes the slots of rank < MS into the chunk's two lists; the
//      walk stops once both counts reach MS. Each chunk's two counts
//      (capped at MS) go to `cnt`;
//   2. shadow_write: a block per env. The chunks' counts are scanned, pair
//      k is (the k-th changer, the k-th free slot), found by binary search
//      of the chunk prefixes; a warp per pair writes the shadow's row, a
//      lane per leaf (kind K_*: the real's row, the target lane, 2^30 +
//      uid, uid | 2^30, the env's ticket, the real's slot, a constant),
//      and the real's partner. Then the env's seq_counter + 1 and, for a
//      changer without a free slot, OV_SLOTS in its overflow.
// Every other slot is left as it is: no per-slot pass over the leaves.
// The leaf descriptors are staged in shared memory by an unrolled loop,
// so no run-time index reaches the parameter struct (no stack frame).
// The kernel moves bytes and computes no float, so the same code serves
// float64 (exact mode) and float32 (fast mode): a leaf is its width in
// bytes.
//
// Hazards of the in-place form (checked by the wrapper's callers and the
// CPU tests):
//   1. The flags it scans, `active`, and `uid` and seq_counter may be the
//      same tensors as the leaves it writes (plan_lane_change passes st
//      and st2 = st with the plan's fields replaced). The scan reads
//      do_change and active in launch 1, before any write; launch 2 reads
//      the env's seq_counter into registers before a barrier and writes
//      it after the last one.
//   2. A shadow copies its real's row while the real's partner is
//      written: partner is K_PARTNER, never copied. A real is active and
//      a shadow's slot was free, so no row is both read and written.
//   3. plan_lane_change's state belongs to the step: where the caller
//      keeps its state (core/step.step, donate=False), G11 spawn_slots
//      gave every per-slot leaf a fresh tensor and G12 and the leader scan
//      the rest, so that state is never written; where the caller donates
//      it (the batched entries), G11 and G15 both write it.
//
// Bound: bytes. The change and active flags (read until both lists are
// full), per pair its real's copied row and the shadow's whole row, the
// real's partner, and the per-env scalars.
#include "gen1.cuh"

using namespace gen1;

constexpr int MAX_LEAVES = 40;
enum { K_COPY, K_CONST, K_DRV, K_PRIORITY, K_UID, K_SEQ, K_PARTNER };
constexpr unsigned SHADOW_BIT = 1u << 30;
constexpr int OV_SLOTS_ = 1;
constexpr int SI_THREADS = 256;
constexpr int SI_WARPS = SI_THREADS / 32;
constexpr int MAX_NCH = SI_THREADS;     // chunks an env, one a thread

struct ShadowLeaf {
  char* p;            // (B, V, ...) the leaf, written in place
  int width;          // bytes a slot
  int kind;           // K_*
  long long cbits;    // K_CONST: the value's bits
};

struct ShadowArgs {
  ShadowLeaf leaf[MAX_LEAVES];
  const uint8_t* do_change;  // (B, V) G7's decision
  const uint8_t* active;     // (B, V) before the insert
  const int* target;         // (B, V) G7's target lane
  const int* uid;            // (B, V) before the insert
  const int* seq_in;         // (B,) seq_counter before the step
  int* seq_out;              // (B,) seq_in + 1 (may be seq_in)
  int* overflow;             // (B,) in place
  int* cnt;                  // (B, nch, 2) scratch: capped counts
  int* pos;                  // (B, nch, 2, MS) scratch: the chunk's lists
  int B, V, MS, nleaf, nch, chunk;
};

template <int W>
__global__ void __launch_bounds__(SI_THREADS)
shadow_scan(const ShadowArgs a) {
  __shared__ int wsum[SI_WARPS];
  const int b = blockIdx.y, c = blockIdx.x;
  const int lo = c * a.chunk;
  const int hi = min(a.V, lo + a.chunk);
  const uint8_t* dc = a.do_change + b * a.V;
  const uint8_t* ac = a.active + b * a.V;
  int* out_ch = a.pos + (b * a.nch + c) * 2 * a.MS;
  int* out_fr = out_ch + a.MS;
  int run_ch = 0, run_fr = 0;           // the same in every thread
  for (int t0 = lo; t0 < hi && (run_ch < a.MS || run_fr < a.MS);
       t0 += SI_THREADS * W) {
    const int s0 = t0 + (int)threadIdx.x * W;
    unsigned mch = 0, mfr = 0;
    if (s0 < hi) {
      if (W == 16) {                    // hi is a multiple of 16 here
        const uint4 d = __ldg((const uint4*)(dc + s0));
        const uint4 f = __ldg((const uint4*)(ac + s0));
        mch = byte_bits(d.x) | byte_bits(d.y) << 4 | byte_bits(d.z) << 8 |
              byte_bits(d.w) << 12;
        mfr = byte_bits(~f.x) | byte_bits(~f.y) << 4 |
              byte_bits(~f.z) << 8 | byte_bits(~f.w) << 12;
      } else {
        mch = __ldg(dc + s0) != 0;
        mfr = __ldg(ac + s0) == 0;
      }
    }
    int tot;
    const int ex = block_scan<SI_THREADS>(__popc(mch) | (__popc(mfr) << 16),
                                          &tot, wsum);
    int r = run_ch + (ex & 0xFFFF);
    for (; mch && r < a.MS; mch &= mch - 1) out_ch[r++] = s0 + __ffs(mch) - 1;
    r = run_fr + (ex >> 16);
    for (; mfr && r < a.MS; mfr &= mfr - 1) out_fr[r++] = s0 + __ffs(mfr) - 1;
    run_ch += tot & 0xFFFF;
    run_fr += tot >> 16;
  }
  if (threadIdx.x == 0) {
    int* n = a.cnt + (b * a.nch + c) * 2;
    n[0] = min(run_ch, a.MS);
    n[1] = min(run_fr, a.MS);
  }
}

// the k-th slot of list f (0 changers, 1 free slots) of env b: in the
// last chunk whose exclusive prefix is <= k
__device__ __forceinline__ int kth(const ShadowArgs& a, int b, int f, int k,
                                   const int* pre) {
  int lo = 0, hi = a.nch - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= k) lo = mid; else hi = mid - 1;
  }
  return a.pos[((b * a.nch + lo) * 2 + f) * a.MS + (k - pre[lo])];
}

__global__ void __launch_bounds__(SI_THREADS)
shadow_write(const ShadowArgs a) {
  __shared__ ShadowLeaf sl[MAX_LEAVES];
  __shared__ int pre[2][MAX_NCH];
  __shared__ int wsum[SI_WARPS];
  const int b = blockIdx.x;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAX_LEAVES; ++i)
      if (i < a.nleaf) sl[i] = a.leaf[i];
  }
  // plain loads: target, uid and seq_in may alias what this launch writes
  const int seq0 = a.seq_in[b];
  const int t = threadIdx.x;
  const int* n = a.cnt + (b * a.nch + t) * 2;
  int tot_ch, tot_fr;
  const int ex_ch =
      block_scan<SI_THREADS>(t < a.nch ? n[0] : 0, &tot_ch, wsum);
  const int ex_fr =
      block_scan<SI_THREADS>(t < a.nch ? n[1] : 0, &tot_fr, wsum);
  if (t < a.nch) {
    pre[0][t] = ex_ch;
    pre[1][t] = ex_fr;
  }
  __syncthreads();
  const int nchg = min(tot_ch, a.MS);
  const int npair = min(nchg, tot_fr);
  const int w = t >> 5, lane = t & 31;
  const int base = b * a.V;
  for (int k = w; k < npair; k += SI_WARPS) {
    const int real = kth(a, b, 0, k, pre[0]);
    const int slot = kth(a, b, 1, k, pre[1]);
    const long long from = base + real, to = base + slot;
    for (int i = lane; i < a.nleaf; i += 32) {
      const ShadowLeaf& L = sl[i];
      char* d = L.p + to * L.width;
      switch (L.kind) {
        case K_COPY: copy_row(d, L.p + from * L.width, L.width); break;
        case K_DRV: *(int*)d = a.target[from]; break;
        case K_PRIORITY:
          *(int*)d = (int)(SHADOW_BIT + (unsigned)a.uid[from]);
          break;
        case K_UID:
          *(int*)d = (int)(SHADOW_BIT | (unsigned)a.uid[from]);
          break;
        case K_SEQ: *(int*)d = seq0; break;
        case K_PARTNER:
          *(int*)d = real;                       // the shadow -> its real
          *(int*)(L.p + from * L.width) = slot;  // the real -> its shadow
          break;
        default: copy_row(d, (const char*)&L.cbits, L.width);
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    a.seq_out[b] = seq0 + 1;
    if (nchg > tot_fr) a.overflow[b] |= OV_SLOTS_;
  }
}

extern "C" int shadow_insert(const ShadowArgs* args, void* stream) {
  const ShadowArgs& a = *args;
  if (a.V == 0 || a.B == 0) return 0;
  if (a.nch < 1 || a.nch > MAX_NCH || a.nleaf > MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = a.V % 16 == 0 && a.chunk % 16 == 0 &&
                   (uintptr_t)a.do_change % 16 == 0 &&
                   (uintptr_t)a.active % 16 == 0;
  const dim3 grid((unsigned)a.nch, (unsigned)a.B);
  if (vec)
    shadow_scan<16><<<grid, SI_THREADS, 0, st>>>(a);
  else
    shadow_scan<1><<<grid, SI_THREADS, 0, st>>>(a);
  shadow_write<<<(unsigned)a.B, SI_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
