// L4 lc_partner: each row's partner values by uid match in the partner
// lane column (real and shadow in lockstep, engine.cpp:195-243), in two
// modes.
//
// Replaces partner_fetch in cityflow_tpu/core/ring_lc.py (:534-567): there
// the uid / shadow / occupancy channels and the C fetched channels are
// permuted to both neighbour columns (2 * (3 + C) slabs through the shift
// plan) and an SL-long where-chain selects the first match. A lane-change
// step asks three times (p1's lockstep min, then the commit's two pair
// rounds) on the same uid, sh, dir, chg and n_l: nothing writes them in
// between. So:
//
//   match   (p1) finds, for every (slot, lane, env) row, the first slot of
//           the partner column (a real looks toward l_dir, a shadow toward
//           -l_dir; the outer column where that is > 0, else the inner)
//           holding the same uid and the other shadow flag, below that
//           column's n_l; writes it to `match` (int16: the slot, bit 14
//           the outer side; -1 for none), `found` (a match on a paired
//           row: an occupied changing real, or an occupied shadow, with a
//           direction) and the C channels read there (0 without a match);
//   gather  (the two later calls) reads `match` and the C channels there,
//           with no walk.
//
// Layout: a block holds W envs (a tile of the env axis) x LB lanes x Y
// slot threads, W and LB in the low bits of the thread index, so a warp
// spans 32 (env, lane) columns at one slot: at B >= 32 a block is one
// lane and 32 envs, and every load of a slot's rows is a 128-byte line
// across the warp; at B = 1 (the ring Engine) a warp is 32 adjacent lanes
// at one slot, whose rows are adjacent too. Each thread takes every Y-th
// slot of its column. W, Y and LB come from B and S (w_l_y below). In the
// match mode the block first stages both neighbour columns' uid and sh of
// its (env, lane) columns (below their n_l) in shared memory with
// coalesced loads, then each thread searches its rows there. Offsets are
// 32-bit (the wrapper refuses S * N * B past 2^31), no division per
// element. (Four rows a thread with their loads issued together were
// slower at B = 128: 40 registers, not 26; PERF.md, Findings.)
//
// Bound: bytes. Match: every row's uid, sh, dir and chg, n_l, the tables,
// the outputs (C floats, found, match), the C channels at the rows that
// find a match. Gather: every row's match, the outputs, the C channels at
// the rows with a match.
#include <algorithm>

#include "common.cuh"

#define MAX_C 4
#define LP_THREADS 256
#define LP_MAX_S 16384       // the slot field of `match` (bits 0-13)

struct LcPartnerArgs {
  const int* uid;        // (S, N, B)
  const uint8_t* sh;
  const int* dir;
  const int* n_l;        // (N, B)
  const uint8_t* chg;
  const float* ch[MAX_C];  // (S, N, B) each
  int C;
  float* out;            // (C, S, N, B)
  uint8_t* found;        // (S, N, B), match mode
  int16_t* match;        // (S, N, B): written in match mode, read in gather
  const int* inner;      // (N,)
  const int* outer;
  int S, N, B;
};

struct Tile {
  int lw, y;             // the thread's (lane, env) column in the block, slot
  int p, b;              // its lane and env
  bool live;
};

__device__ __forceinline__ Tile tile(const LcPartnerArgs& a, int lgw, int lgl,
                                     int lgy) {
  Tile t;
  const int tid = threadIdx.x;
  const int w = tid & ((1 << lgw) - 1);
  const int l = (tid >> lgw) & ((1 << lgl) - 1);
  t.lw = tid & ((1 << (lgw + lgl)) - 1);
  t.y = tid >> (lgw + lgl);
  t.p = ((int)blockIdx.x << lgl) + l;
  t.b = ((int)blockIdx.y << lgw) + w;
  t.live = t.y < (1 << lgy) && t.p < a.N && t.b < a.B;
  return t;
}

// the C channels' values at partner row f (0 where there is none)
__device__ __forceinline__ void put(const LcPartnerArgs& a, int e, int f,
                                    bool hit, int SNB) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < a.C) a.out[c * SNB + e] = hit ? __ldg(a.ch[c] + f) : 0.0f;
}

__global__ void __launch_bounds__(LP_THREADS)
lc_partner_match(const LcPartnerArgs a, int lgw, int lgl, int lgy) {
  extern __shared__ int s_uid[];        // (2, S, LW): inner, outer
  const Tile t = tile(a, lgw, lgl, lgy);
  const int LW = 1 << (lgw + lgl), Y = 1 << lgy;
  const int S = a.S, N = a.N, B = a.B;
  uint8_t* s_sh = (uint8_t*)(s_uid + 2 * S * LW);
  int qi = -1, qo = -1, ni = 0, no = 0;
  if (t.live) {
    qi = __ldg(a.inner + t.p);
    qo = __ldg(a.outer + t.p);
    ni = qi >= 0 ? min(max(__ldg(a.n_l + qi * B + t.b), 0), S) : 0;
    no = qo >= 0 ? min(max(__ldg(a.n_l + qo * B + t.b), 0), S) : 0;
    for (int s = t.y; s < ni; s += Y) {
      const int f = (s * N + qi) * B + t.b;
      s_uid[s * LW + t.lw] = __ldg(a.uid + f);
      s_sh[s * LW + t.lw] = __ldg(a.sh + f);
    }
    for (int s = t.y; s < no; s += Y) {
      const int f = (s * N + qo) * B + t.b;
      s_uid[(S + s) * LW + t.lw] = __ldg(a.uid + f);
      s_sh[(S + s) * LW + t.lw] = __ldg(a.sh + f);
    }
  }
  __syncthreads();
  if (!t.live) return;
  const int SNB = S * N * B;
  const int n_own = __ldg(a.n_l + t.p * B + t.b);
  for (int s = t.y; s < S; s += Y) {
    const int e = (s * N + t.p) * B + t.b;
    const int uid = __ldg(a.uid + e);
    const bool shv = __ldg(a.sh + e) != 0;
    const int d = __ldg(a.dir + e);
    // torch.where(sh, -dir, dir) in int32: wraps at INT_MIN
    const int look = shv ? (int)(0u - (unsigned)d) : d;
    const bool out = look > 0;
    const int base = (out ? S * LW : 0) + t.lw;
    const int n = out ? no : ni;
    int hit = -1;
    for (int u = 0; u < n; ++u) {
      if (s_uid[base + u * LW] == uid && (s_sh[base + u * LW] != 0) != shv) {
        hit = u;
        break;
      }
    }
    put(a, e, hit >= 0 ? (hit * N + (out ? qo : qi)) * B + t.b : 0,
        hit >= 0, SNB);
    const bool paired = s < n_own && (shv || __ldg(a.chg + e) != 0) &&
                        look != 0;
    a.found[e] = hit >= 0 && paired;
    a.match[e] = hit >= 0 ? (int16_t)(hit | (out << 14)) : (int16_t)-1;
  }
}

__global__ void __launch_bounds__(LP_THREADS)
lc_partner_gather(const LcPartnerArgs a, int lgw, int lgl, int lgy) {
  const Tile t = tile(a, lgw, lgl, lgy);
  if (!t.live) return;
  const int Y = 1 << lgy;
  const int S = a.S, N = a.N, B = a.B;
  const int SNB = S * N * B;
  const int qi = __ldg(a.inner + t.p), qo = __ldg(a.outer + t.p);
  for (int s = t.y; s < S; s += Y) {
    const int e = (s * N + t.p) * B + t.b;
    const int m = __ldg(a.match + e);
    const bool hit = m >= 0;
    const int f = hit ? ((m & 0x3FFF) * N + (m >> 14 ? qo : qi)) * B + t.b
                      : 0;
    put(a, e, f, hit, SNB);
  }
}

static int ceil_log2(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

// the block's layout: W = 2^lgw envs (up to 32, no wider than B needs),
// Y = 2^lgy slot threads (up to 8, no more than S needs), LB = 2^lgl lanes
// filling LP_THREADS; the match mode's staging must fit its shared memory
// (LB, then W, halved until it does; the gather mode stages nothing and
// passes no limit)
static void w_l_y(int S, int B, size_t smem_max, int* lgw, int* lgl,
                  int* lgy, size_t* smem) {
  const int lgt = ceil_log2(LP_THREADS);
  *lgw = std::min(5, ceil_log2(B));
  *lgy = std::min(3, ceil_log2(S));
  for (;;) {
    *lgl = lgt - *lgw - *lgy;
    for (;;) {
      *smem = (size_t)2 * S * ((size_t)1 << (*lgw + *lgl)) *
              (sizeof(int) + 1);
      if (*smem <= smem_max || *lgl == 0) break;
      --*lgl;
    }
    if (*smem <= smem_max || *lgw == 0) return;
    --*lgw;
  }
}

// the device's opt-in shared memory a block, asked once a device
static size_t smem_optin() {
  static int known[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int v = dev >= 0 && dev < 64 ? known[dev] : 0;
  if (v == 0) {
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (dev >= 0 && dev < 64) known[dev] = v;
  }
  return (size_t)v;
}

// mode 0: match, 1: gather
extern "C" int lc_partner(const LcPartnerArgs* args, int mode, void* stream) {
  const LcPartnerArgs a = *args;
  if ((long long)a.S * a.N * a.B == 0) return 0;
  if (a.C < 1 || a.C > MAX_C || a.S > LP_MAX_S) return -1;
  const size_t smem_max = mode == 0 ? smem_optin() : SIZE_MAX;
  int lgw, lgl, lgy;
  size_t smem;
  w_l_y(a.S, a.B, smem_max, &lgw, &lgl, &lgy, &smem);
  if (smem > smem_max) return -1;
  const dim3 grid((unsigned)((a.N + (1 << lgl) - 1) >> lgl),
                  (unsigned)((a.B + (1 << lgw) - 1) >> lgw));
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          lc_partner_match, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    lc_partner_match<<<grid, LP_THREADS, smem, st>>>(a, lgw, lgl, lgy);
  } else {
    lc_partner_gather<<<grid, LP_THREADS, 0, st>>>(a, lgw, lgl, lgy);
  }
  return (int)cudaGetLastError();
}
