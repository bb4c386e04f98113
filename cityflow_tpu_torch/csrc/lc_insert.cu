// L3 lc_insert: per target lane up to LCI shadow winners, the senders'
// change start, and the rank-preserving shadow inserts of every lane
// channel (reference LaneChange::insertShadow, lanechange.cpp:71-102;
// scheduleLaneChange, engine.cpp:792-820), IN PLACE on the lane leaves.
//
// Replaces the schedule part of lc_phase in cityflow_tpu/core/ring_lc.py
// (:369-531). The TPU version permutes the do_change / dir / dis channels
// and then the whole shadow bundle (20 + 2 * MAXLPR channels) to both
// neighbour columns (b_in / b_out), extracts each winner's bundle with an
// SL-long where-chain per channel, and inserts with a full-slab shift per
// winner and channel, out of place. Here only what changes is touched:
//
//   lc_select_kernel<K>  one thread per (target lane, env) column. It walks
//                        the occupied rows of its inner column (direction
//                        +1), then of its outer column (direction -1),
//                        slots ascending, once each, and keeps the top LCI
//                        senders by distance in registers (a strictly
//                        greater distance displaces; a tie keeps the
//                        first); more than LCI candidates set overflow bit
//                        1. With a winner it counts its own occupied rows
//                        with dis >= each winner's dis (the insert ranks),
//                        refuses the inserts a full ring cannot take
//                        (overflow bit 2), gathers every inserted winner's
//                        channel values into scratch, and queues the
//                        column on a work list. It writes the winner codes
//                        (the plain version's `accepted`, refused ones
//                        included) for the next launch;
//   lc_start_kernel<K>   one thread per column: its rows whose shadow won
//                        the target lane start changing (chg, and dir =
//                        dirc unless a shadow), read from the winner codes
//                        of its two neighbour columns as the plain version
//                        reads them (a missing neighbour reads code 0);
//   lc_insert_kernel     one thread per (queued column, channel): the rows
//                        from the first insert rank to S - 1 shift down by
//                        the inserts above them (unoccupied rows too, as
//                        the plain version's shift does) and the winners'
//                        values go in at their ranks; n_l grows by the
//                        inserts.
// K is the top list's length, 1, 2, 4 or 8 (the least one >= LCI), so
// that every per-thread array is indexed by unrolled constants: no stack
// frame. The channel descriptors are staged in shared memory, so that a
// run-time channel index does not index the parameter struct.
//
// Hazards of the in-place form:
//   1. A column can be a source and a target in one call: lane p sends a
//      shadow to q while q's own column shifts. The winners' values are
//      gathered into scratch (LCI, channels, N, B) in the first launch,
//      before any row moves; the shifts run in the third.
//   2. Only three kinds of row change: the shifted tail of a column with
//      an insert; the started rows (chg, dir); and dir where
//      where(sh, dir, where(chg2, dirc, 0)) differs from dir. The last
//      happens only on started rows given what L1 and the commit
//      guarantee: l_dir is 0 on every row that is neither a shadow nor
//      changing (the commit epilogue writes where(sh | chg, dir, 0), the
//      admission writes 0, the vacated rows take the fill 0), and L1's
//      dirc is l_dir on the changing rows. So there is no full dir pass.
//      The selection also takes L1's plan (hence do_change) on occupied
//      rows only, and walks n_l rows of each neighbour.
//   3. No later code reads a pre-insert lane leaf: the started marks read
//      only do_change, dirc and sh (never written here), the gathers read
//      channels that are not written before the third launch, and n_l is
//      written there too, after both of its readers.
//
// Bound: bytes. The neighbour columns' occupied do_change, the senders'
// dirc and dis, n_l, the winners' values (read once, written once), the
// target columns' own occupied dis, the shifted tail rows of each column
// with an insert (every channel read and written once), the started rows'
// chg and dir, and the overflow bits: small against the lane ring, which
// the out-of-place form copied whole.
#include "common.cuh"

#define MAX_CH 40
#define SHBIT (1 << 30)

enum { W_SAME = 0, W_CONST = 1, W_NXT = 2, W_NXT3 = 3, W_PRI = 4, W_DIR = 5 };

struct InsChan {
  void* ring;        // (S, N, B) lane leaf, written in place
  const void* src;   // the winner's value: W_SAME the ring itself, W_NXT /
                     // W_NXT3 rnrow / auxrow (M, S, N, B), W_PRI uid,
                     // W_DIR dirc; W_CONST none
  int width;         // bytes per slot: 4 or 1
  int win;           // W_*
  unsigned cval;     // W_CONST: the value's bits (0 / 1 for a bool)
};

struct LcInsertArgs {
  InsChan ch[MAX_CH];
  int nch;
  const uint8_t* do_change;  // (S, N, B) from L2
  const int* dirc;           // from L1
  const float* dis;          // the dis leaf (before the inserts)
  const uint8_t* sh;
  uint8_t* chg;              // written: started rows
  int* dir;                  // written: started rows
  int* n_l;                  // (N, B), written: + inserts
  const int* rnrow;          // (M, S, N, B)
  const int* auxrow;
  const int* inner;          // (N,) neighbour lane column, -1: none
  const int* outer;
  const int* llocal;         // (N,) lane index in its road
  int* acc;                  // scratch (LCI, N, B) winner codes, -1 none
  int* pos;                  // (LCI, N, B) insert ranks
  int* nins;                 // (N, B) inserts of a queued column
  unsigned* wval;            // (LCI, nch, N, B) the winners' values
  int* work;                 // (N * B) queued columns
  int* nwork;                // (1,) their count, zeroed before the launch
  uint8_t* ovl;              // (N, B) overflow bits
  int S, N, B, M, LCI;
};

constexpr int SEL_THREADS = 128;
constexpr int SEL_UNROLL = 8;     // neighbour do_change flags loaded together
constexpr int INS_THREADS = 128;
constexpr int INS_BLOCKS = 512;
constexpr int INS_ROWS = 8;       // rows loaded together before the stores

__device__ __forceinline__ void stage_chans(const LcInsertArgs& a,
                                            InsChan* sch) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < MAX_CH; ++i)
      if (i < a.nch) sch[i] = a.ch[i];
  }
  __syncthreads();
}

template <int K>
__global__ void __launch_bounds__(SEL_THREADS)
lc_select_kernel(const LcInsertArgs a) {
  __shared__ InsChan sch[MAX_CH];
  stage_chans(a, sch);
  const int NB = a.N * a.B;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= NB) return;
  const int p = c / a.B, b = c - p * a.B;
  const int S = a.S, lci = a.LCI;
  float td[K];
  int tc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    td[j] = -INFINITY;
    tc[j] = -1;
  }
  int ncand = 0;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int q = side == 0 ? a.inner[p] : a.outer[p];
    if (q < 0) continue;
    const int want = side == 0 ? 1 : -1;
    const int base = q * a.B + b;
    const int nq = min(max(a.n_l[base], 0), S);
    for (int t0 = 0; t0 < nq; t0 += SEL_UNROLL) {
      uint8_t dc[SEL_UNROLL];
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u)
        dc[u] = t0 + u < nq ? a.do_change[(t0 + u) * NB + base] : 0;
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        if (!dc[u]) continue;
        const int f = (t0 + u) * NB + base;
        if (a.dirc[f] != want) continue;
        ++ncand;
        float d = a.dis[f];
        int code = side * S + t0 + u;
        // insert into the descending list; once in, the rest move down
        bool in = false;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (in || d > td[j]) {
            const float x = td[j];
            const int y = tc[j];
            td[j] = d;
            tc[j] = code;
            d = x;
            code = y;
            in = true;
          }
        }
      }
    }
  }
  uint8_t ov = ncand > lci ? 1 : 0;
  if (tc[0] < 0) {               // no winner: the codes are all -1
    a.acc[c] = -1;
    a.ovl[c] = ov;
    return;
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < lci) a.acc[j * NB + c] = tc[j];
  // insert ranks on the original ring: its occupied rows with dis >= the
  // winner's, plus the winners above
  const int n_raw = a.n_l[c];
  const int nown = min(max(n_raw, 0), S);
  int cnt[K];
#pragma unroll
  for (int j = 0; j < K; ++j) cnt[j] = 0;
  for (int t = 0; t < nown; ++t) {
    const float d = a.dis[t * NB + c];
#pragma unroll
    for (int j = 0; j < K; ++j) cnt[j] += d >= td[j];
  }
  // the inserts a full ring refuses (a suffix of the winners)
  int ncur = n_raw, k = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < lci && tc[j] >= 0) {
      if (ncur >= S) {
        ov |= 2;
      } else {
        a.pos[j * NB + c] = cnt[j] + j;
        ++ncur;
        ++k;
      }
    }
  }
  a.ovl[c] = ov;
  if (k == 0) return;
  // the inserted winners' values, read before any row moves
  const int SNB = S * NB;
  const int nch = a.nch;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j >= k) break;
    const int side = tc[j] >= S ? 1 : 0;
    const int t = tc[j] - side * S;
    const int q = side ? a.outer[p] : a.inner[p];
    const int f = t * NB + q * a.B + b;
    const int lo = a.llocal[q] + (side ? -1 : 1);
    const bool in_m = lo >= 0 && lo < a.M;
    unsigned* wv = a.wval + j * nch * NB + c;
    for (int ci = 0; ci < nch; ++ci) {
      const InsChan& h = sch[ci];
      unsigned v;
      if (h.win == W_SAME) {
        v = h.width == 4 ? ((const unsigned*)h.src)[f]
                         : (unsigned)((const uint8_t*)h.src)[f];
      } else if (h.win == W_CONST) {
        v = h.cval;
      } else if (h.win == W_NXT) {
        v = in_m ? (unsigned)((const int*)h.src)[lo * SNB + f] : ~0u;
      } else if (h.win == W_NXT3) {
        const int aux = in_m ? ((const int*)h.src)[lo * SNB + f] : -1;
        v = aux >= 0 ? (unsigned)((aux >> 1) - 2) : ~0u;
      } else if (h.win == W_PRI) {
        v = (unsigned)SHBIT + ((const unsigned*)h.src)[f];
      } else {
        v = ((const unsigned*)h.src)[f];
      }
      wv[ci * NB] = v;
    }
  }
  a.nins[c] = k;
  a.work[atomicAdd(a.nwork, 1)] = c;
}

template <int K>
__global__ void __launch_bounds__(SEL_THREADS)
lc_start_kernel(const LcInsertArgs a) {
  const int NB = a.N * a.B;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= NB) return;
  const int p = c / a.B, b = c - p * a.B;
  const int S = a.S, lci = a.LCI;
  // side 0: my rows going +1 won a slot in my outer column (its codes
  // below S); side 1: my rows going -1 (or 0) in my inner one (codes S +
  // slot)
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int q = side == 0 ? a.outer[p] : a.inner[p];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= lci || (q < 0 && j > 0)) break;
      const int code = q >= 0 ? a.acc[j * NB + q * a.B + b] : 0;
      if (code < 0) break;
      const int t = code - side * S;
      if (t < 0 || t >= S) continue;
      const int f = t * NB + c;
      const int dc = a.dirc[f];
      if (!a.do_change[f] || (side == 0 ? dc <= 0 : dc > 0)) continue;
      a.chg[f] = 1;
      if (!a.sh[f]) a.dir[f] = dc;
    }
  }
}

__global__ void __launch_bounds__(INS_THREADS)
lc_insert_kernel(const LcInsertArgs a) {
  __shared__ InsChan sch[MAX_CH];
  stage_chans(a, sch);
  const int NB = a.N * a.B;
  const int nch = a.nch;
  const int total = *a.nwork * nch;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int w = i / nch, ci = i - w * nch;
    const int c = a.work[w];
    const int k = a.nins[c];
    if (ci == 0) a.n_l[c] += k;
    const InsChan& h = sch[ci];
    const bool wide = h.width == 4;
    unsigned* r4 = (unsigned*)h.ring + c;
    uint8_t* r1 = (uint8_t*)h.ring + c;
    const unsigned* wv = a.wval + ci * NB + c;
    const int p0 = a.pos[c];
    // walk up from the last row: row s is winner jj's where s is its rank,
    // else row s - (jj + 1); loads of a batch before its stores, so every
    // load reads a row not yet written
    int jj = k - 1;
    int pj = a.pos[jj * NB + c];
    for (int s0 = a.S - 1; s0 >= p0; s0 -= INS_ROWS) {
      unsigned v[INS_ROWS];
#pragma unroll
      for (int u = 0; u < INS_ROWS; ++u) {
        const int s = s0 - u;
        if (s < p0) break;
        if (s == pj) {
          v[u] = wv[jj * nch * NB];
          --jj;
          pj = jj >= 0 ? a.pos[jj * NB + c] : -1;
        } else {
          const int r = (s - (jj + 1)) * NB;
          v[u] = wide ? r4[r] : (unsigned)r1[r];
        }
      }
#pragma unroll
      for (int u = 0; u < INS_ROWS; ++u) {
        const int s = s0 - u;
        if (s < p0) break;
        if (wide) r4[s * NB] = v[u];
        else r1[s * NB] = (uint8_t)v[u];
      }
    }
  }
}

template <int K>
static int launch(const LcInsertArgs& a, int blocks, cudaStream_t st) {
  lc_select_kernel<K><<<blocks, SEL_THREADS, 0, st>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  lc_start_kernel<K><<<blocks, SEL_THREADS, 0, st>>>(a);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  lc_insert_kernel<<<INS_BLOCKS, INS_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int lc_insert(const LcInsertArgs* args, void* stream) {
  const LcInsertArgs& a = *args;
  const long long NB = (long long)a.N * a.B;
  if (NB == 0 || a.S == 0) return 0;
  if (a.nch > MAX_CH || a.nch < 1 || a.LCI < 1 || a.LCI > 8) return -1;
  if ((long long)(a.M > 0 ? a.M : 1) * a.S * NB >= (1LL << 31) ||
      (long long)a.LCI * a.nch * NB >= (1LL << 31))
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(a.nwork, 0, sizeof(int), st);
  if (rc) return rc;
  const int blocks = (int)((NB + SEL_THREADS - 1) / SEL_THREADS);
  if (a.LCI <= 1) return launch<1>(a, blocks, st);
  if (a.LCI <= 2) return launch<2>(a, blocks, st);
  if (a.LCI <= 4) return launch<4>(a, blocks, st);
  return launch<8>(a, blocks, st);
}
