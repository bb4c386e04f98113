// G1 arrange: the reference's per-drivable vehicle lists (distance desc,
// ties by insertion ticket, then slot), each vehicle's leader, each
// drivable's first and last vehicle, and the per-lanelink tables of the
// first k_link vehicles with their attribute packs.
//
// Replaces arrangement in cityflow_tpu/core/step.py (:48-115), which the
// TPU computes as one 3-key lax.sort of all V slots followed by shifted
// compares, a cummax and scatters. Here nothing is sorted globally:
//   1. count the running vehicles of each drivable (int atomics);
//   2. one block scans the counts into bucket offsets, and the running
//      flags into each slot's count of running slots before it;
//   3. each running vehicle drops its slot into its drivable's bucket
//      through an atomic cursor (order inside a bucket arbitrary);
//   4. each vehicle counts the bucket members ahead of it in the key
//      (-dis in lax.sort's total order, list_seq, slot): that count is its
//      rank, and the member just ahead is its leader; it writes every
//      output at offset[drv] + rank. Slots that are not running follow the
//      running ones in slot order.
// The key is a total order with the slot as its last term, so the result
// is the sort's whatever order the atomics left inside a bucket.
//
// Bound: bytes. A step reads each slot's flag, drivable, distance and
// ticket and writes the sorted index, the leader and the tables; step 4
// does (bucket size) compares per vehicle, a few tens on a jammed lane, so
// operations stay far below the card's rate.
#include "gen1.cuh"

using namespace gen1;

struct ArrangeArgs {
  const uint8_t* running;  // (V,)
  const int* drv;          // (V,)
  const void* dis;         // (V,) T
  const int* list_seq;     // (V,)
  const void* fattrs;      // (V, NA) T, or null: no link tables
  const int* iattrs;       // (V, NI)
  // scratch: cnt (D+1) | cursor (D+1) | off (D+2) | bucket (V) | nrb (V+1);
  // cnt and cursor zeroed by the caller
  int* scratch;
  int* sorted_idx;         // (V,)
  int* leader;             // (V,)
  int* first_of;           // (D,) filled with -1 by the caller
  int* last_of;            // (D,) filled with -1 by the caller
  int* link_veh;           // (LLr, k_link) filled with -1, or null
  void* link_fattr;        // (LLr, k_link, NA) zeroed, or null
  int* link_iattr;         // (LLr, k_link, NI) zeroed, or null
  uint8_t* overflow;       // () zeroed
  long long V, D, L, k_link, NA, NI, fp32;
};

struct Scratch {
  int *cnt, *cursor, *off, *bucket, *nrb;
  __device__ Scratch(const ArrangeArgs& a) {
    cnt = a.scratch;
    cursor = cnt + (a.D + 1);
    off = cursor + (a.D + 1);
    bucket = off + (a.D + 2);
    nrb = bucket + a.V;
  }
};

__global__ void arrange_count(const ArrangeArgs a) {
  Scratch s(a);
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    if (a.running[v]) atomicAdd(&s.cnt[a.drv[v]], 1);
  }
}

__global__ void arrange_scan(const ArrangeArgs a) {
  __shared__ int sh[1024];
  Scratch s(a);
  block_exclusive_scan(s.cnt, s.off, a.D, sh);
  block_exclusive_scan(a.running, s.nrb, a.V, sh);
}

__global__ void arrange_scatter(const ArrangeArgs a) {
  Scratch s(a);
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    if (!a.running[v]) continue;
    int b = a.drv[v];
    int p = s.off[b] + atomicAdd(&s.cursor[b], 1);
    s.bucket[p] = (int)v;
  }
}

template <typename T>
__global__ void arrange_rank(const ArrangeArgs a) {
  Scratch s(a);
  const T* dis = (const T*)a.dis;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    if (!a.running[v]) {
      a.sorted_idx[s.off[a.D] + (v - s.nrb[v])] = (int)v;
      a.leader[v] = -1;
      continue;
    }
    int b = a.drv[v];
    int lo = s.off[b], hi = s.off[b + 1];
    long long kv = order_key(-dis[v]);
    int lv = a.list_seq[v];
    int r = 0, pred = -1, lp = 0;
    long long kp = 0;
    for (int j = lo; j < hi; ++j) {
      int u = s.bucket[j];
      if (u == v) continue;
      long long ku = order_key(-dis[u]);
      int lu = a.list_seq[u];
      bool ahead = ku < kv || (ku == kv && (lu < lv || (lu == lv && u < v)));
      if (!ahead) continue;
      ++r;
      if (pred < 0 || kp < ku || (kp == ku && (lp < lu ||
                                               (lp == lu && pred < u)))) {
        pred = u;
        kp = ku;
        lp = lu;
      }
    }
    a.sorted_idx[lo + r] = (int)v;
    a.leader[v] = pred;
    if (r == 0) a.first_of[b] = (int)v;
    if (r == hi - lo - 1) a.last_of[b] = (int)v;
    if (b >= a.L) {
      if (r < a.k_link) {
        if (a.link_veh != nullptr) {
          long long row = (b - a.L) * a.k_link + r;
          a.link_veh[row] = (int)v;
          const T* fa = (const T*)a.fattrs + v * a.NA;
          T* out = (T*)a.link_fattr + row * a.NA;
          for (long long c = 0; c < a.NA; ++c) out[c] = fa[c];
          for (long long c = 0; c < a.NI; ++c)
            a.link_iattr[row * a.NI + c] = a.iattrs[v * a.NI + c];
        }
      } else {
        *a.overflow = 1;
      }
    }
  }
}

extern "C" int arrange(const ArrangeArgs* args, void* stream) {
  const ArrangeArgs a = *args;
  if (a.V == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  unsigned blocks = grid_blocks(a.V, threads);
  arrange_count<<<blocks, threads, 0, st>>>(a);
  arrange_scan<<<1, 1024, 0, st>>>(a);
  arrange_scatter<<<blocks, threads, 0, st>>>(a);
  GEN1_LAUNCH(arrange_rank, a, blocks, threads, 0, st);
  return (int)cudaGetLastError();
}
