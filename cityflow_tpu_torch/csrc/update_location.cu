// G10 update_location: Engine::threadUpdateLocation and the main-stage
// push of the gen-1 step (reference engine.cpp:282-315, 477-494): the
// finish statistics of the vehicles removed this step, and the new list
// order and lanelink entry time of the vehicles that moved to another
// drivable.
//
// Replaces update_location in cityflow_tpu/core/step.py (:830-881): a
// nonzero compaction and a fori_loop sum over G1's sorted order (exact),
// or an unordered jnp.sum (fast, :855-857), and an argsort of all V slots
// by -dis for the transfer ranks. Here, in one call:
//   1. flags (all slots): removed = running & end; counted = removed, not
//      a finished lane change; transferring = running & changed & not
//      removed; exact mode also writes the counted flags in G1's sorted
//      order;
//   2. one block: scans the transfer flags into a compact list of the
//      transferring slots (slot order) and, exact mode, the sorted counted
//      flags into positions; the travel times of the first max_remove
//      counted slots in sorted order go to a buffer that one thread sums
//      left to right from 0 (the reference's single-thread order; OV_REMOVE
//      past max_remove). Fast mode sums every counted slot instead: each
//      thread a fixed strided share of the slots, then a fixed tree in
//      shared memory, with no float atomics, so two runs agree bit for
//      bit (the plain version's torch.sum adds in another order: close,
//      not bitwise);
//   3. all slots: a transferring slot's rank is the count of transferring
//      slots before it in (-dis, slot) order, -0.0 equal to 0.0 (the
//      order of a stable sort; O(transfers^2) compares over the compact
//      list, a few hundred transfers a step on a 30x30 grid), its new
//      list ticket seq_counter + rank and its entry time (the step on a
//      lanelink, INT_MAX on a lane); the rest keep theirs.
//
// Bound: bytes. The flags read each slot's running / end / changed /
// distance / drivable once (and the lane-change flags); the outputs are
// the removed flags, two int32 columns and four scalars. The rank
// compares are transfers^2, far below the card's rate at these counts.
#include "gen1.cuh"

using namespace gen1;

struct UpdateLocationArgs {
  const uint8_t* running;     // (V,)
  const uint8_t* end;         // (V,) the step's route end / lane-change end
  const uint8_t* changed;     // (V,) moved to another drivable
  const void* buf_dis;        // (V,) T the distance after the move
  const int* buf_drv;         // (V,) the drivable after the move
  const void* enter_time;     // (V,) T
  const int* list_seq;        // (V,)
  const int* enter_ll_time;   // (V,)
  const int* sorted_idx;      // (V,) G1's order; exact mode only
  const uint8_t* lc_finished; // (V,) or null (no lane change)
  const uint8_t* finish;      // (V,) or null
  const int* step;            // ()
  const int* seq_counter;     // ()
  const int* finished_cnt;    // ()
  const void* cum_travel;     // () T
  const int* overflow;        // ()
  const void* interval;       // () T
  uint8_t* removed;           // (V,) out
  int* list_seq_out;          // (V,)
  int* enter_ll_out;          // (V,)
  int* finished_out;          // ()
  void* cum_out;              // () T
  int* seq_out;               // ()
  int* overflow_out;          // ()
  // scratch: trans flags (V) | sorted counted flags (V) as uint8, then
  // int trans positions (V + 1) | counted positions (V + 1) | trans list
  // (V), then T vals (max_remove)
  uint8_t* flags;
  int* iscratch;
  void* vals;
  long long V, R, L, exact, fp32;
};

constexpr int INT_MAX_ = 2147483647;
constexpr int OV_REMOVE_ = 8;

__device__ __forceinline__ bool counted_of(const UpdateLocationArgs& a,
                                           long long v) {
  bool rm = a.running[v] && a.end[v];
  if (a.lc_finished != nullptr) rm = rm && !(a.lc_finished[v] || a.finish[v]);
  return rm;
}

template <typename T>
__device__ __forceinline__ long long rank_key(T x) {
  // -0.0 sorts equal to 0.0 and every NaN last, as a stable sort of the
  // floats orders them
  if (isnan(x)) return 0x7FFFFFFFFFFFFFFFLL;
  return order_key(x == T(0) ? T(0) : x);
}

__global__ void ul_flags(const UpdateLocationArgs a) {
  uint8_t* trans = a.flags;
  uint8_t* csorted = a.flags + a.V;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    bool rm = a.running[v] && a.end[v];
    a.removed[v] = rm;
    trans[v] = a.running[v] && a.changed[v] && !rm;
    if (a.exact) csorted[v] = counted_of(a, a.sorted_idx[v]);
  }
}

template <typename T>
__global__ void ul_reduce(const UpdateLocationArgs a) {
  __shared__ int sh[1024];
  __shared__ __align__(8) unsigned char red_raw[1024 * sizeof(double)];
  T* red = (T*)red_raw;
  const uint8_t* trans = a.flags;
  const uint8_t* csorted = a.flags + a.V;
  int* tpos = a.iscratch;
  int* cpos = tpos + (a.V + 1);
  int* tlist = cpos + (a.V + 1);
  T* vals = (T*)a.vals;
  const T* et = (const T*)a.enter_time;
  const T now = T(*a.step) * *(const T*)a.interval;
  const int t = threadIdx.x, nt = blockDim.x;

  block_exclusive_scan(trans, tpos, a.V, sh);
  for (long long v = t; v < a.V; v += nt)
    if (trans[v]) tlist[tpos[v]] = (int)v;

  T total = T(0);
  int n_counted;
  if (a.exact) {
    block_exclusive_scan(csorted, cpos, a.V, sh);
    n_counted = cpos[a.V];
    for (long long i = t; i < a.R; i += nt) vals[i] = T(0);
    __syncthreads();
    for (long long p = t; p < a.V; p += nt) {
      if (csorted[p] && cpos[p] < a.R) {
        int s = a.sorted_idx[p];
        vals[cpos[p]] = now - et[s];
      }
    }
    __syncthreads();
    if (t == 0)
      for (long long i = 0; i < a.R; ++i) total = total + vals[i];
  } else {
    T part = T(0);
    int cnt = 0;
    for (long long v = t; v < a.V; v += nt) {
      if (counted_of(a, v)) {
        part = part + (now - et[v]);
        ++cnt;
      }
    }
    red[t] = part;
    sh[t] = cnt;
    __syncthreads();
    for (int o = nt / 2; o > 0; o >>= 1) {
      if (t < o) {
        red[t] = red[t] + red[t + o];
        sh[t] += sh[t + o];
      }
      __syncthreads();
    }
    total = red[0];
    n_counted = sh[0];
  }
  if (t == 0) {
    *a.finished_out = *a.finished_cnt + n_counted;
    *(T*)a.cum_out = *(const T*)a.cum_travel + total;
    *a.seq_out = *a.seq_counter + tpos[a.V];
    *a.overflow_out = *a.overflow |
                      ((a.exact && n_counted > a.R) ? OV_REMOVE_ : 0);
  }
}

template <typename T>
__global__ void ul_rank(const UpdateLocationArgs a) {
  const uint8_t* trans = a.flags;
  const int* tpos = a.iscratch;
  const int* tlist = tpos + 2 * (a.V + 1);
  const int n = tpos[a.V];
  const T* dis = (const T*)a.buf_dis;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    if (!trans[v]) {
      a.list_seq_out[v] = a.list_seq[v];
      a.enter_ll_out[v] = a.enter_ll_time[v];
      continue;
    }
    long long kv = rank_key(-dis[v]);
    int r = 0;
    for (int j = 0; j < n; ++j) {
      int u = tlist[j];
      long long ku = rank_key(-dis[u]);
      r += (ku < kv) || (ku == kv && u < v);
    }
    a.list_seq_out[v] = *a.seq_counter + r;
    a.enter_ll_out[v] = a.buf_drv[v] >= a.L ? *a.step : INT_MAX_;
  }
}

extern "C" int update_location(const UpdateLocationArgs* args,
                               void* stream) {
  const UpdateLocationArgs a = *args;
  if (a.V == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  unsigned blocks = grid_blocks(a.V, threads);
  ul_flags<<<blocks, threads, 0, st>>>(a);
  GEN1_LAUNCH(ul_reduce, a, 1, 1024, 0, st);
  GEN1_LAUNCH(ul_rank, a, blocks, threads, 0, st);
  return (int)cudaGetLastError();
}
