// G1 arrange: the reference's per-drivable vehicle lists (distance desc,
// ties by insertion ticket, then slot), each vehicle's leader, each
// drivable's first and last vehicle, and each drivable's first position in
// the sorted order (drv_off: a lanelink's first k_link vehicles are
// sorted_idx[drv_off[L + ll] + r], r < min(k_link, its count), the JAX
// package's link table row without the table).
//
// Replaces arrangement in cityflow_tpu/core/step.py (:48-115), which the
// TPU computes as one 3-key lax.sort of all V slots followed by shifted
// compares, a cummax and scatters, and dense per-lanelink tables of
// attribute packs. Here nothing is sorted globally and no table is built;
// one memset of the counters and four launches, each spreading an env
// over many blocks, each thread issuing its loads together (32 32-bit
// loads or stores of a warp cover 128 adjacent bytes):
//   1. count: 128 adjacent slots a warp, four rounds of its 32 lanes;
//      each running vehicle adds one to its drivable's count (an int
//      atomic whose result nothing waits for); each warp stores how many
//      of its slots are not running;
//   2. scan: a chunk of 4096 counts a block, staged in shared memory; its
//      prefix from the chunks before it by a decoupled look-back (each
//      block takes its chunk from a ticket, so every chunk it waits on
//      has started): drv_off, first_of / last_of -1 (whole words: step
//      4 writes the drivables that hold vehicles), the overflow test (a
//      lanelink with more than k_link);
//   3. place: the same warps; each running vehicle takes a position in
//      its drivable's bucket from a second int atomic and writes its sort
//      record there (key, ticket, slot, drivable: 16 bytes in float32, 24
//      in float64; order inside a bucket arbitrary); each slot that is
//      not running goes after the running ones in slot order (the earlier
//      warps' counts, a ballot a round); leader -1 for every slot (step 4
//      writes the running ones);
//   4. rank: 256 bucket positions a block, their records read in order
//      and kept in shared memory (the envs in reverse order); each vehicle counts the members of its
//      drivable ahead of it there (the members of a drivable that crosses
//      the block's edges staged tile by tile): that count is its rank,
//      the nearest of them its leader.
// The key is -dis in lax.sort's order (sort_key: -0.0 ties with +0.0,
// NaNs tie last), then the ticket, then the slot: a total order, so the
// result is the sort's whatever order the atomics left inside a bucket.
//
// B envs at once: every kernel takes its env from blockIdx.y and shifts
// each per-env pointer to that env's rows (at_env), so slot indices stay
// local to their env.
//
// Bound: bytes. The running flags, each running slot's drivable, distance
// and ticket in; sorted_idx and leader over the slots, first_of, last_of
// and drv_off over the drivables out. Step 4 compares each vehicle with
// the others of its drivable, a few tens on a jammed lane.
#include <type_traits>

#include "gen1.cuh"

using namespace gen1;

constexpr int AR_THREADS = 256;
constexpr int AR_W = 4;                            // slots a lane, 1 / 3
constexpr int AR_TILE = AR_THREADS * AR_W;         // slots a block
constexpr int AR_WARPS = AR_THREADS / 32;
constexpr int AR_CH = 4096;                        // counts a scan block
constexpr int AR_ITEMS = AR_CH / AR_THREADS;       // counts a thread
constexpr unsigned long long AR_AGG = 1ull << 32,  // look-back flags
    AR_INCL = 2ull << 32;

// a running vehicle's sort record: -dis's key in lax.sort's order
// (sort_key: 32 bits in float32), its ticket, slot and drivable (16 bytes
// in float32, 24 in float64)
template <typename T>
struct Rec {
  typedef typename std::conditional<sizeof(T) == 4, int, long long>::type
      Key;
  Key key;
  int ls, v, d;
};

// every array below is per env: B of them back to back
struct ArrangeArgs {
  const uint8_t* running;  // (V,)
  const int* drv;          // (V,)
  const void* dis;         // (V,) T
  const int* list_seq;     // (V,)
  // zeroed here: cnt (D+1) | ovf | ticket | (pad) | status (NCH, 64-bit)
  // | cursor (D+1), NZ ints an env (NZ % 4 == 0: each env's counters
  // start on a 16-byte word)
  int* zeroed;
  // warp_nr (NT * AR_WARPS), NW ints an env
  int* work;
  void* rec;               // (V,) Rec<T>, the bucket
  int* sorted_idx;         // (V,)
  int* leader;             // (V,)
  int* first_of;           // (D,)
  int* last_of;            // (D,)
  int* drv_off;            // (D+1,)
  uint8_t* overflow;       // ()
  long long B, V, D, L, k_link, NZ, NW, fp32;
};

__host__ __device__ inline long long n_tiles(long long V) {
  return V > 0 ? (V + AR_TILE - 1) / AR_TILE : 1;
}

__host__ __device__ inline long long status_at(long long D) {
  return (D + 3 + 1) & ~1LL;      // after cnt, ovf and ticket; 8-byte
}

// the arguments of env b: every pointer moved to that env's rows
__device__ ArrangeArgs at_env(ArrangeArgs a, long long b) {
  const long long V = a.V, D = a.D;
  a.running += b * V;
  a.drv += b * V;
  a.dis = (const char*)a.dis + b * V * (a.fp32 ? 4 : 8);
  a.list_seq += b * V;
  a.zeroed += b * a.NZ;
  a.work += b * a.NW;
  a.rec = (char*)a.rec + b * V * (a.fp32 ? sizeof(Rec<float>)
                                          : sizeof(Rec<double>));
  a.sorted_idx += b * V;
  a.leader += b * V;
  a.first_of += b * D;
  a.last_of += b * D;
  a.drv_off += b * (D + 1);
  a.overflow += b;
  return a;
}

__host__ __device__ inline long long n_chunks(long long D) {
  return (D + AR_CH) / AR_CH;
}

struct Scratch {
  int *cnt, *ovf, *ticket, *cursor, *warp_nr;
  unsigned long long* status;
  __device__ Scratch(const ArrangeArgs& a) {
    cnt = a.zeroed;
    ovf = cnt + (a.D + 1);
    ticket = ovf + 1;
    status = (unsigned long long*)(a.zeroed + status_at(a.D));
    cursor = (int*)(status + n_chunks(a.D));
    warp_nr = a.work;
  }
};

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  return x;
}

// the AR_W slots of lane `lane` of warp `gw` (of its env): a warp's 128
// adjacent slots, lane-major, so that each round's loads and stores are
// a warp's adjacent words
__device__ __forceinline__ long long slot_of(long long gw, int lane, int i) {
  return gw * (32 * AR_W) + i * 32 + lane;
}

__global__ void __launch_bounds__(AR_THREADS)
arrange_count(const ArrangeArgs a0) {
  const ArrangeArgs a = at_env(a0, blockIdx.y);
  const Scratch s(a);
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * AR_WARPS + (threadIdx.x >> 5);
  bool run[AR_W];
  int d[AR_W], nr = 0;
#pragma unroll
  for (int i = 0; i < AR_W; ++i) {
    const long long v = slot_of(gw, lane, i);
    run[i] = v < a.V && a.running[v];
    nr += v < a.V && !run[i];
  }
#pragma unroll
  for (int i = 0; i < AR_W; ++i)
    if (run[i]) d[i] = a.drv[slot_of(gw, lane, i)];
#pragma unroll
  for (int i = 0; i < AR_W; ++i)
    if (run[i]) atomicAdd(&s.cnt[d[i]], 1);
  nr = warp_sum(nr);
  if (lane == 0) s.warp_nr[gw] = nr;
}

__global__ void __launch_bounds__(AR_THREADS)
arrange_scan(const ArrangeArgs a0) {
  const ArrangeArgs a = at_env(a0, blockIdx.y);
  const Scratch s(a);
  // AR_CH counts, one int of padding every 32 (a thread reads its
  // AR_ITEMS adjacent counts without bank conflicts)
  __shared__ int sm[AR_CH + AR_CH / 32];
  __shared__ int wsum[AR_WARPS];
  __shared__ int cid_s, pre;
  const int t = threadIdx.x;
  auto pad = [](int i) { return i + (i >> 5); };
  if (t == 0) cid_s = atomicAdd(s.ticket, 1);
  __syncthreads();
  const int cid = cid_s;
  const long long i0 = (long long)cid * AR_CH;
  int xc[AR_ITEMS];                  // coalesced: count i0 + j * 256 + t
#pragma unroll
  for (int j = 0; j < AR_ITEMS; ++j) {
    const long long i = i0 + j * AR_THREADS + t;
    xc[j] = i <= a.D ? s.cnt[i] : 0;
    sm[pad(j * AR_THREADS + t)] = xc[j];
  }
  __syncthreads();
  int x[AR_ITEMS], sum = 0;          // this thread's adjacent counts
#pragma unroll
  for (int j = 0; j < AR_ITEMS; ++j) {
    x[j] = sm[pad(t * AR_ITEMS + j)];
    sum += x[j];
  }
  int total;
  int run = block_scan<AR_THREADS>(sum, &total, wsum);
  if (t == 0) {
    // decoupled look-back over the chunks before this one
    unsigned long long* st = s.status;
    int prefix = 0;
    if (cid == 0) {
      atomicExch(st, AR_INCL | (unsigned)total);
    } else {
      atomicExch(st + cid, AR_AGG | (unsigned)total);
      for (int j = cid - 1; j >= 0;) {
        const unsigned long long w = *(volatile unsigned long long*)(st + j);
        if (w < AR_AGG) continue;                   // not published yet
        prefix += (int)(unsigned)w;
        if (w >= AR_INCL) break;
        --j;
      }
      atomicExch(st + cid, AR_INCL | (unsigned)(prefix + total));
    }
    pre = prefix;
  }
  __syncthreads();
  run += pre;
#pragma unroll
  for (int j = 0; j < AR_ITEMS; ++j) {
    sm[pad(t * AR_ITEMS + j)] = run;
    run += x[j];
  }
  __syncthreads();
  bool over = false;
#pragma unroll
  for (int j = 0; j < AR_ITEMS; ++j) {
    const long long i = i0 + j * AR_THREADS + t;
    if (i <= a.D) a.drv_off[i] = sm[pad(j * AR_THREADS + t)];
    if (i < a.D) {
      a.first_of[i] = -1;
      a.last_of[i] = -1;
    }
    over |= i >= a.L && i < a.D && xc[j] > a.k_link;
  }
  if (__syncthreads_or(over) && t == 0) atomicOr(s.ovf, 1);
}

template <typename T>
__global__ void __launch_bounds__(AR_THREADS)
arrange_place(const ArrangeArgs a0) {
  const ArrangeArgs a = at_env(a0, blockIdx.y);
  const Scratch s(a);
  __shared__ int red[AR_WARPS], wn[AR_WARPS];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long tile = blockIdx.x, gw = tile * AR_WARPS + w;
  // every load first: the slots that are not running in the tiles before
  // this one, this tile's warps, the running count, this thread's slots
  int p = 0;
  for (long long i = t; i < tile * AR_WARPS; i += AR_THREADS)
    p += s.warp_nr[i];
  if (t < AR_WARPS) wn[t] = s.warp_nr[tile * AR_WARPS + t];
  const int nrun = a.drv_off[a.D];
  bool run[AR_W];
  int d[AR_W], ls[AR_W], lo[AR_W], at[AR_W];
  T dis[AR_W];
#pragma unroll
  for (int i = 0; i < AR_W; ++i) {
    const long long v = slot_of(gw, lane, i);
    run[i] = v < a.V && a.running[v];
  }
#pragma unroll
  for (int i = 0; i < AR_W; ++i)
    if (run[i]) {
      const long long v = slot_of(gw, lane, i);
      d[i] = a.drv[v];
      dis[i] = ((const T*)a.dis)[v];
      ls[i] = a.list_seq[v];
    }
#pragma unroll
  for (int i = 0; i < AR_W; ++i)
    if (run[i]) {
      lo[i] = a.drv_off[d[i]];
      at[i] = atomicAdd(&s.cursor[d[i]], 1);
    }
  p = warp_sum(p);
  if (lane == 0) red[w] = p;
  __syncthreads();
  if (tile == 0 && t == 0) *a.overflow = *s.ovf != 0;
  int q = nrun;
#pragma unroll
  for (int i = 0; i < AR_WARPS; ++i) q += red[i] + (i < w ? wn[i] : 0);
  // the slots that are not running, in slot order after the running
  // ones: each round's in lane order (a ballot)
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < AR_W; ++i) {
    const long long v = slot_of(gw, lane, i);
    const bool in = v < a.V;
    const unsigned idle = __ballot_sync(0xFFFFFFFFu, in && !run[i]);
    if (in) a.leader[v] = -1;          // the running ones: step 4
    if (run[i])
      ((Rec<T>*)a.rec)[lo[i] + at[i]] = Rec<T>{
          (typename Rec<T>::Key)sort_key(-dis[i]), ls[i], (int)v, d[i]};
    else if (in)
      a.sorted_idx[q + __popc(idle & below)] = (int)v;
    q += __popc(idle);
  }
}

// (key, ticket, slot) of u ahead of (key, ticket, slot) of v
__device__ __forceinline__ bool ahead(long long ku, int lu, int u,
                                      long long kv, int lv, int v) {
  return ku < kv || (ku == kv && (lu < lv || (lu == lv && u < v)));
}

struct Rank {
  int r, pred, lp;
  long long kp;
  __device__ void take(long long ku, int lu, int u, long long kv, int lv,
                       int v) {
    if (!ahead(ku, lu, u, kv, lv, v)) return;
    ++r;
    if (pred < 0 || ahead(kp, lp, pred, ku, lu, u)) {
      pred = u;
      kp = ku;
      lp = lu;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(AR_THREADS)
arrange_rank(const ArrangeArgs a0) {
  // the envs in the order opposite to step 3's, so that the last envs it
  // wrote are read while their records are still in L2
  const ArrangeArgs a = at_env(a0, gridDim.y - 1 - blockIdx.y);
  const Rec<T>* rec = (const Rec<T>*)a.rec;
  __shared__ long long sk[AR_THREADS], xk[AR_THREADS];
  __shared__ int sl[AR_THREADS], sv[AR_THREADS], xl[AR_THREADS],
      xv[AR_THREADS];
  __shared__ int edge[4];   // lo of the first member, its drivable; hi of
                            // the last, its drivable
  const int nrun = a.drv_off[a.D];
  const int t = threadIdx.x;
  // the block's runs of AR_THREADS positions, up to the running count
  for (int p0 = blockIdx.x * AR_THREADS; p0 < nrun;
       p0 += gridDim.x * AR_THREADS) {
    const int nact = min(AR_THREADS, nrun - p0);
    const bool act = t < nact;
    int v = -1, d = -1, lo = 0, hi = 0, lv = 0;
    long long kv = 0;
    if (act) {
      const Rec<T> r = rec[p0 + t];
      d = r.d;
      lo = a.drv_off[d];
      hi = a.drv_off[d + 1];
      kv = r.key;
      lv = r.ls;
      v = r.v;
      sk[t] = kv;
      sl[t] = lv;
      sv[t] = v;
      if (t == 0) {
        edge[0] = lo;
        edge[1] = d;
      }
      if (t == nact - 1) {
        edge[2] = hi;
        edge[3] = d;
      }
    }
    __syncthreads();
    Rank rk{0, -1, 0, 0};
    if (act) {
      const int j1 = min(hi, p0 + nact) - p0;
      for (int j = max(lo, p0) - p0; j < j1; ++j)
        if (j != t) rk.take(sk[j], sl[j], sv[j], kv, lv, v);
    }
    // the members of the first and the last drivable outside the run
    const int loA = edge[0], dA = edge[1], hiZ = edge[2], dZ = edge[3];
    for (int side = 0; side < 2; ++side) {
      const int q0 = side == 0 ? loA : p0 + nact;
      const int q1 = side == 0 ? p0 : hiZ;
      const int dd = side == 0 ? dA : dZ;
      for (int q = q0; q < q1; q += AR_THREADS) {
        const int n = min(AR_THREADS, q1 - q);
        if (t < n) {
          const Rec<T> r = rec[q + t];
          xk[t] = r.key;
          xl[t] = r.ls;
          xv[t] = r.v;
        }
        __syncthreads();
        if (act && d == dd)
          for (int j = 0; j < n; ++j)
            rk.take(xk[j], xl[j], xv[j], kv, lv, v);
        __syncthreads();
      }
    }
    if (act) {
      a.sorted_idx[lo + rk.r] = v;
      a.leader[v] = rk.pred;
      if (rk.r == 0) a.first_of[d] = v;
      if (rk.r == hi - lo - 1) a.last_of[d] = v;
    }
    __syncthreads();                  // sk and edge are rewritten next
  }
}

extern "C" int arrange(const ArrangeArgs* args, void* stream) {
  const ArrangeArgs a = *args;
  if (a.B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(a.zeroed, 0, a.B * a.NZ * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const dim3 tiles((unsigned)n_tiles(a.V), (unsigned)a.B);
  const dim3 chunks((unsigned)n_chunks(a.D), (unsigned)a.B);
  // rank: enough blocks to fill the card a few times over, each walking
  // its env's positions up to the running count (known on the card only)
  const long long per_env =
      a.V > 0 ? (a.V + AR_THREADS - 1) / AR_THREADS : 1;
  const long long cap = 8192 / a.B > 16 ? 8192 / a.B : 16;
  const dim3 pos((unsigned)(per_env < cap ? per_env : cap), (unsigned)a.B);
  arrange_count<<<tiles, AR_THREADS, 0, st>>>(a);
  arrange_scan<<<chunks, AR_THREADS, 0, st>>>(a);
  GEN1_LAUNCH(arrange_place, a, tiles, AR_THREADS, 0, st);
  GEN1_LAUNCH(arrange_rank, a, pos, AR_THREADS, 0, st);
  return (int)cudaGetLastError();
}
