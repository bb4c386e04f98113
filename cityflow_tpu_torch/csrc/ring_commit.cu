// K4 ring_commit: shift a ring column out by its front departures and
// append the column's entrants, for every channel in one pass.
//
// Replaces the link-ring commit (shift_out + append_k, 12 channels) and the
// lane-ring commit (stable sort of the A candidates by distance descending,
// then shift_out + append of at most SA of them) in
// cityflow_tpu/core/ring.py (:1644-1907). The TPU runs these as one masked
// select per (shift, channel) and a sorting network along A.
//
// The lane-change mode (ring.py:1815-1857) takes a delete mask instead of the
// front departures: the TPU composes prefix exits and mid-ring finishes
// into one rank-preserving delete as XD + 1 masked shifts per channel; here
// each output slot takes the kept slot of its rank (a kept slot that moves
// up by more than XD is dropped, as the where-chain drops it).
//
// Bound: bytes. Per (column, env) pair: the surviving slots of every
// channel read once and all S slots written once, plus the entrants' flags,
// keys and values; no arithmetic to speak of.
//
// Design. The rings are (S, N, B), so the N * B (column, env) pairs of one
// slot are contiguous. A block owns RC_P = 128 consecutive pairs (a few
// columns at small B, part of one at large B), one thread a pair, and all
// their slots, which it takes in chunks of R output rows (one chunk where
// the S rows fit the shared memory, as they do up to about 130-200
// slots):
//  1. the plan, once: the thread's shift x, its base, and the candidates
//     that land at base, base + 1, ... (the stable order by a rank count
//     over the candidates' keys in registers; the order into shared
//     memory). The channel descriptors go into shared memory too, copied
//     with constant indices: no parameter is indexed at run time. In the
//     delete mode, for each chunk before its first store, the thread
//     walks its column's delete mask on to the chunk's last output row
//     and keeps each row's source row (into shared memory);
//  2. the stream, chunk by chunk and in each chunk channel by channel:
//     the tile of the block's pairs for the chunk's rows and the next XK
//     (XD in the delete mode; the halo) lands in shared memory through
//     16-byte cp.async copies (no registers held), and with it each
//     pair's entrant values where they land in the chunk (4-byte copies);
//     double-buffered, so one tile is written out while the next one's
//     copies are in flight (the first one's while the plan is made). Each
//     thread then writes its pair's rows of the chunk: row s from the
//     tile's row of its source slot (bank-conflict free: neighbouring
//     threads, neighbouring words), or the fill (in the delete mode a
//     fill row of the tile, so the loop has no test), an entrant's value
//     from shared memory over it. So the global loads are whole rows
//     whatever the pairs' shifts, the stores 128-byte segments a warp,
//     and no store waits on a load: with the entrants read in the slot
//     loop, a warp whose envs hold their entrants at different slots
//     stalled on a dependent load at nearly every slot. A source past the
//     tile (a shift or delete cap longer than the halo a tile can carry)
//     is read from the ring itself, in a loop of its own that a warp (a
//     chunk in the delete mode) takes only where it needs it. Values move
//     as bits: only fills and entrants convert.
// Tiles fall back to single elements, loaded at once, where N * B * size
// % 16 != 0, a pointer is not 16-byte aligned or the block is the last,
// partial one.
#include "common.cuh"

#define MAX_CH 32
#define MAX_A 16
#define RC_P 128          // threads a block = the pairs a block owns
#define MAX_SMEM (200 * 1024)   // dynamic shared memory a block may take
#define SRC_FILL 0xffff   // delete mode: the row takes the fill
#define MAX_XD 65000      // delete mode: a row's source - s0 fits 16 bits

enum { K_F32 = 0, K_I32 = 1, K_BOOL = 2, K_PRI = 3 };

struct Chan {
  const void* upd;  // (S, N, B) ring before the shift
  void* out;        // (S, N, B)
  int kind;
  int app_ch;       // entrant channel; -1 = per-env value envval[b]
  int app_ch2;      // K_PRI: low half channel
  float fill;       // value shifted in behind the last slot
};

struct RingCommitArgs {
  Chan ch[MAX_CH];
  int nch;
  int XK;
  long long S, N, B;
  const int* x;         // (N, B) front departures per column
  const int* base;      // (N, B) first free slot after departures
  const float* app;     // (A, PCH, AC, B) entrant candidates
  long long A, PCH, AC;
  long long app_I;      // 0: column n is entrant column n; else lane column
  long long app_G;      //    n = ol * app_I + g maps to ol * app_G + g, g < app_G
  int valid_ch;         // candidate valid flag channel (> 0.5)
  int sort_ch;          // -1: take candidates in order; else stable sort by
                        //     this channel descending, valid first
  int nsel;             // candidates taken
  const float* envval;  // (B,)
  const uint8_t* dmask; // lane-change mode: (S, N, B) delete mask, else null
  int XD;               //   at most XD slots deleted above a kept one
};

namespace {

// a channel as the stream reads it
struct SChan {
  const void* upd;
  void* out;
  uint32_t fill;    // the fill's bits in the ring's type
  int app_ch, app_ch2;
  int kind;
};

__device__ __forceinline__ int hilo_to_i32(float h, float l) {
  return (int)(((unsigned)xla_f32_to_i32(h)) << 16) | xla_f32_to_i32(l);
}

// torch.sort's ascending order: NaN after everything, NaNs equal
__device__ __forceinline__ bool key_lt(float a, float b) {
  return isnan(b) ? !isnan(a) : a < b;
}

// an entrant's value (hi: its channel app_ch, or the per-env value; lo:
// channel app_ch2, read for a priority only) as the ring's bits; a fill
// converts as (fill, fill)
template <typename T>
__device__ __forceinline__ T entrant(int kind, float hi, float lo) {
  switch (kind) {
    case K_F32: return (T)__float_as_uint(hi);
    case K_I32: return (T)(uint32_t)xla_f32_to_i32(hi);
    case K_BOOL: return (T)(hi > 0.5f ? 1 : 0);
    default: return (T)(uint32_t)hilo_to_i32(hi, lo);
  }
}

// cp.async: a 16-byte copy from device to shared memory that does not
// pass through registers; completion by commit groups
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows s0 .. s0 + rows - 1 of the channel for the block's np pairs into
// `buf` (row stride RC_P values): 16-byte cp.async copies where the rows
// allow, else element by element at once
template <typename T>
__device__ __forceinline__ void tile_load(const SChan& c, uint4* buf,
                                          int s0, int rows, int np,
                                          long long e0, long long total) {
  const T* upd = (const T*)c.upd + s0 * total + e0;
  if (np == RC_P && (total * sizeof(T)) % 16 == 0 &&
      (uintptr_t)upd % 16 == 0) {
    constexpr int wpr = RC_P * (int)sizeof(T) / 16;   // words a row
    for (int w = threadIdx.x; w < rows * wpr; w += blockDim.x) {
      const int s = w / wpr;
      cp_async16(buf + w, reinterpret_cast<const uint4*>(upd + s * total) +
                              (w - s * wpr));
    }
  } else {
    T* tl = (T*)buf;
    for (int i = threadIdx.x; i < rows * np; i += blockDim.x) {
      const int s = i / np;
      tl[s * RC_P + (i - s * np)] = __ldg(upd + s * total + (i - s * np));
    }
  }
}

__device__ __forceinline__ void tile_load(const SChan& c, uint4* buf,
                                          int s0, int rows, int np,
                                          long long e0, long long total) {
  if (c.kind == K_BOOL)
    tile_load<uint8_t>(c, buf, s0, rows, np, e0, total);
  else
    tile_load<uint32_t>(c, buf, s0, rows, np, e0, total);
}

// phase 2 for one channel and the output rows s0 .. s1 - 1, the tile of
// rows s0 .. t1 - 1 (its row RT, past them, this thread's fill in the
// delete mode) and the entrants' values in shared memory: row s of this
// thread's pair takes its source slot's value, or the fill; an entrant
// overlays it. A source past the tile (a shift longer than the tile's
// halo; `far`: a chunk whose delete cap is) is read from the ring itself.
template <typename T, bool DEL>
__device__ __forceinline__ void tile_store(
    const SChan& c, int S, int s0, int s1, int t1, int RT, bool far,
    uint4* buf, const float* ent, int nsel, int x, int base, int cnt,
    long long e, long long total, const uint16_t* src_of) {
  T* tl = (T*)buf + threadIdx.x;
  const T* upd = (const T*)c.upd + e;
  T* out = (T*)c.out + e;
  const T fill = (T)c.fill;
  auto put = [&](int s, T v) {
    const long long k = (long long)s - base;
    if (k >= 0 && k < cnt)
      v = entrant<T>(c.kind, ent[k * RC_P], ent[(nsel + k) * RC_P]);
    out[s * total] = v;
  };
  if (!DEL) {
    // a source past the tile is the fill, unless a shift of this warp
    // (whose rows are stored together) runs past the tile's halo
    if (!__any_sync(__activemask(), t1 < S && x > t1 - s1)) {
#pragma unroll 8
      for (int s = s0; s < s1; ++s)
        put(s, s + x < t1 ? tl[(s + x - s0) * RC_P] : fill);
    } else {
      for (int s = s0; s < s1; ++s) {
        const int src = s + x;
        put(s, src >= S  ? fill
               : src < t1 ? tl[(src - s0) * RC_P]
                          : __ldg(upd + src * total));
      }
    }
  } else if (!far) {
    // src_of: each row's source row in the tile, RT for the fill
    tl[RT * RC_P] = fill;
#pragma unroll 4
    for (int s = s0; s < s1; ++s) put(s, tl[src_of[(s - s0) * RC_P] * RC_P]);
  } else {
    // src_of: each row's source minus s0, SRC_FILL for the fill
    for (int s = s0; s < s1; ++s) {
      const int r = src_of[(s - s0) * RC_P];
      put(s, r == SRC_FILL  ? fill
             : r < t1 - s0 ? tl[r * RC_P]
                           : __ldg(upd + (s0 + r) * total));
    }
  }
}

// the delete walk's place: the next output row, the next slot, the slots
// deleted so far
struct Walk { int k_out, tin, ndel; };

// the sources of one pair's output rows s0 .. s1 - 1 in the delete mode,
// as rows from s0 (`fillr` for the fill), into src_of (row stride RC_P):
// the kept slots in order while at most XD slots above them are deleted
// (once a kept slot is dropped every later row takes the fill); the mask
// (slot stride `stride`) read eight slots at a time, the walk going on
// from where the chunk before left it. Out of line: it runs once a chunk.
__device__ __noinline__ Walk walk_rows(Walk w, const uint8_t* dmask,
                                       long long stride, int S, int XD,
                                       int s0, int s1, uint16_t fillr,
                                       uint16_t* src_of) {
  while (w.k_out < s1 && w.tin < S && w.ndel <= XD) {
    bool m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m[j] = w.tin + j < S && __ldg(dmask + (w.tin + j) * stride);
    int j = 0;
#pragma unroll
    for (; j < 8; ++j) {
      if (w.tin + j >= S || w.k_out >= s1 || w.ndel > XD) break;
      if (m[j])
        ++w.ndel;
      else
        src_of[(w.k_out++ - s0) * RC_P] = (uint16_t)(w.tin + j - s0);
    }
    w.tin += j;
  }
  for (; w.k_out < s1; ++w.k_out) src_of[(w.k_out - s0) * RC_P] = fillr;
  return w;
}

template <bool DEL>
__global__ void __launch_bounds__(RC_P)
ring_commit_kernel(const RingCommitArgs a, int R, int RT) {
  // R output rows a chunk, tiles of at most RT rows (RT = R = S in one
  // chunk; else RT - R rows of halo). Dynamic shared memory: two tiles
  // (RT x RC_P words each, and in the delete mode a fill row: one written
  // out while the next one's copies land), two stages' entrant values
  // (2 x nsel x RC_P floats each: hi, lo), in the delete mode the chunk's
  // source rows (RT x RC_P 16-bit), the entrants' order (MAX_A x RC_P
  // bytes)
  __shared__ SChan sch[MAX_CH];
  extern __shared__ uint4 dyn[];
  const long long total = a.N * a.B;
  const int S = (int)a.S;
  const int nsel = a.nsel;
  const int nch = a.nch;
  const int t = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * RC_P;
  const long long e = e0 + t;
  const int np = (int)(total - e0 < RC_P ? total - e0 : RC_P);
  const int tile_words = (RT + DEL) * RC_P / 4;   // a tile's 16-byte words
  float* ents = reinterpret_cast<float*>(dyn + 2 * tile_words) + t;
  const int ent_floats = 2 * nsel * RC_P; // one stage's entrant values
  uint16_t* src_of = reinterpret_cast<uint16_t*>(ents - t + 2 * ent_floats)
                     + t;
  uint8_t* cand = reinterpret_cast<uint8_t*>(src_of - t +
                                             (DEL ? RT * RC_P : 0)) + t;
  // a stage: channel ci of the chunk of output rows s0 .. s1 - 1, whose
  // tile holds rows s0 .. t1 - 1; stages run chunk by chunk, and in each
  // chunk channel by channel
  struct Stage { int ci, s0, s1, t1; };
  auto next = [&](Stage g) {
    if (++g.ci == nch) {
      g.ci = 0;
      g.s0 += R;
      g.s1 = min(S, g.s0 + R);
      g.t1 = min(S, g.s0 + RT);
    }
    return g;
  };
  auto tiles = [&](const Stage& g, int buf) {
    tile_load(sch[g.ci], dyn + buf * tile_words, g.s0, g.t1 - g.s0, np, e0,
              total);
  };
  Stage cur = {0, 0, min(S, R), min(S, RT)};

  // ---- 1. the channel descriptors: thread i copies channel i (constant
  // indices: no parameter is indexed at run time); then the first tile's
  // copies start while the plan is made
#pragma unroll
  for (int i = 0; i < MAX_CH; ++i) {
    if (t != i || i >= nch) continue;
    const Chan& c = a.ch[i];
    SChan d;
    d.upd = c.upd;
    d.out = c.out;
    d.kind = c.kind;
    d.app_ch = c.app_ch;
    d.app_ch2 = c.app_ch2;
    d.fill = entrant<uint32_t>(c.kind, c.fill, c.fill);
    sch[i] = d;
  }
  __syncthreads();
  tiles(cur, 0);

  // ---- 2. the plan
  int x = 0, base = 0, cnt = 0;
  const float* ap = a.app;                // + (c * PCH + ch) * AC * B
  const long long cs = a.AC * a.B;
  const float* ev = a.envval;
  if (t < np) {
    const long long b = e % a.B;
    const long long n = e / a.B;
    if (ev) ev += b;
    if (!DEL) {
      // the JAX shift takes x in 1 .. XK; anything else shifts by 0
      const int xr = a.x[e];
      x = xr >= 1 && xr <= a.XK ? xr : 0;
    }
    base = a.base[e];
    long long ac = -1;
    if (a.app_I == 0) {
      ac = n;
    } else {
      const long long g = n % a.app_I;
      if (g < a.app_G) ac = (n / a.app_I) * a.app_G + g;
    }
    if (ac >= 0) {
      ap += ac * a.B + b;
      unsigned vmask = 0;
      float key[MAX_A];
#pragma unroll
      for (int c = 0; c < MAX_A; ++c) {
        key[c] = INFINITY;
        if (c < a.A) {
          const bool v = __ldg(ap + (c * a.PCH + a.valid_ch) * cs) > 0.5f;
          vmask |= (unsigned)v << c;
          if (v && a.sort_ch >= 0)
            key[c] = -__ldg(ap + (c * a.PCH + a.sort_ch) * cs);
        }
      }
      if (a.sort_ch >= 0) {
        // stable ascending order of the keys: candidate c goes to rank
        // #{c2 : key[c2] < key[c], or equal and c2 < c}
#pragma unroll
        for (int c = 0; c < MAX_A; ++c) {
          if (c >= a.A) continue;
          int r = 0;
#pragma unroll
          for (int c2 = 0; c2 < MAX_A; ++c2)
            if (c2 < a.A && c2 != c)
              r += key_lt(key[c2], key[c]) ||
                   (!key_lt(key[c], key[c2]) && c2 < c);
          if (r < nsel) cand[r * RC_P] = (uint8_t)c;
        }
        for (int r = 0; r < nsel; ++r) {        // the valid ones, in order
          const int c = cand[r * RC_P];
          if ((vmask >> c) & 1u) cand[cnt++ * RC_P] = (uint8_t)c;
        }
      } else {
        for (int c = 0; c < nsel; ++c)
          if ((vmask >> c) & 1u) cand[cnt++ * RC_P] = (uint8_t)c;
      }
    }
  }

  // the delete mode's sources, chunk by chunk (walk_rows); a chunk is
  // `far` where a kept slot may lie past its tile
  Walk w = {0, 0, 0};
  auto far_of = [&](const Stage& g) {
    return g.t1 < S && g.t1 - g.s1 < a.XD;
  };
  auto walk = [&](const Stage& g) {
    w = walk_rows(w, a.dmask + e, total, S, a.XD, g.s0, g.s1,
                  far_of(g) ? SRC_FILL : RT, src_of);
  };
  if (DEL && t < np) walk(cur);

  // the values of this pair's entrants in a stage's channel where they
  // land in its chunk (4-byte cp.async copies, in the group of the tile)
  auto ents_load = [&](const Stage& g, int buf) {
    if (t >= np || cnt == 0 || base >= g.s1 ||
        (long long)base + cnt <= g.s0)
      return;
    const SChan& c = sch[g.ci];
    float* to = ents + buf * ent_floats;
    for (int k = 0; k < cnt; ++k) {
      const long long cand_k = cand[k * RC_P];
      cp_async4(to + k * RC_P, c.app_ch < 0
                ? ev : ap + (cand_k * a.PCH + c.app_ch) * cs);
      if (c.kind == K_PRI)
        cp_async4(to + (nsel + k) * RC_P,
                  ap + (cand_k * a.PCH + c.app_ch2) * cs);
    }
  };
  ents_load(cur, 0);
  cp_async_commit();

  // ---- 3. the stream: each stage written out of its tile while the next
  // one's copies land in the other
  const int nst = (S + R - 1) / R * nch;
  for (int st = 0; st < nst; ++st) {
    const Stage nx = next(cur);
    const int cb = st & 1;
    if (st + 1 < nst) {
      tiles(nx, cb ^ 1);
      ents_load(nx, cb ^ 1);
    }
    cp_async_commit();                    // (empty past the last stage)
    cp_async_wait_one();                  // this thread's copies of st
    __syncthreads();                      // everyone's
    const SChan c = sch[cur.ci];
    uint4* tile = dyn + cb * tile_words;
    const float* ent = ents + cb * ent_floats;
    if (t < np) {
      const bool far = DEL && far_of(cur);
      if (c.kind == K_BOOL)
        tile_store<uint8_t, DEL>(c, S, cur.s0, cur.s1, cur.t1, RT, far,
                                 tile, ent, nsel, x, base, cnt, e, total,
                                 src_of);
      else
        tile_store<uint32_t, DEL>(c, S, cur.s0, cur.s1, cur.t1, RT, far,
                                  tile, ent, nsel, x, base, cnt, e, total,
                                  src_of);
      // the next chunk's sources (this thread's own column of the table)
      if (DEL && nx.ci == 0 && st + 1 < nst) walk(nx);
    }
    __syncthreads();                      // tile st free for st + 2
    cur = nx;
  }
}

// shared memory a tile row takes: two tiles' rows, in the delete mode the
// row's source
long long row_bytes(bool del) { return RC_P * (2 * 4 + (del ? 2 : 0)); }

// dynamic shared memory of a block whose tiles hold RT rows (and in the
// delete mode a fill row each)
size_t smem_bytes(long long RT, int nsel, bool del) {
  return (size_t)((RT + del) * row_bytes(del)) +
         2 * 2 * (size_t)nsel * RC_P * 4 + (size_t)MAX_A * RC_P;
}

}  // namespace

extern "C" int ring_commit(const RingCommitArgs* args, void* stream) {
  const long long total = args->N * args->B;
  const long long S = args->S;
  if (total == 0 || S == 0) return 0;
  const bool del = args->dmask != nullptr;
  if (args->nch < 1 || args->nch > MAX_CH || args->A > MAX_A ||
      args->nsel > args->A || args->nsel < 0 || S > 0x3fffffff ||
      (del && (args->XD < 0 || args->XD > MAX_XD)))
    return -1;
  // the most tile rows the shared memory holds; where S rows do not fit,
  // chunks of R rows whose tiles carry the next XK (XD) rows too, so that
  // every source but those of a longer shift lies in the tile
  long long RT = (MAX_SMEM - (long long)smem_bytes(0, args->nsel, del)) /
                 row_bytes(del);
  long long R = S;
  if (S <= RT) {
    RT = S;
  } else {
    long long halo = del ? args->XD : args->XK;
    halo = halo < 0 ? 0 : halo > RT / 2 ? RT / 2 : halo;
    R = RT - halo;
  }
  const size_t smem = smem_bytes(RT, args->nsel, del);
  const long long blocks = (total + RC_P - 1) / RC_P;
  if (blocks > 0x7fffffffLL) return -1;
  cudaError_t e = cudaSuccess;
  if (del) {
    e = cudaFuncSetAttribute(ring_commit_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      ring_commit_kernel<true><<<(unsigned)blocks, RC_P, smem,
                                 (cudaStream_t)stream>>>(*args, (int)R,
                                                         (int)RT);
  } else {
    e = cudaFuncSetAttribute(ring_commit_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      ring_commit_kernel<false><<<(unsigned)blocks, RC_P, smem,
                                  (cudaStream_t)stream>>>(*args, (int)R,
                                                          (int)RT);
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
