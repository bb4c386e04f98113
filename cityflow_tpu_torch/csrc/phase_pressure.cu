// O2 phase_pressure: MaxPressure per candidate phase, the DQN's per-phase
// features and the MaxPressure action, a thread per (intersection, env).
//
// Replaces phase_pressures, phase_features and max_pressure_phases_ring in
// cityflow_tpu/core/ring_observe.py (:35-112). There the waiting counts go
// through the forward exchange and three typed one-hot einsums (E_start,
// E_end, E_rl) once per phase, an (LPI, G) slab each. A link l of
// intersection g has a start lane in_src(start_src(l, g)) (-1 for none),
// an end lane end_src(l, g), and is available in phase ph when its
// roadlink row rl_src = rl * G + col is not -1 and phase_rl_avail[
// clip(g_phase_offset[col] + ph, 0, TP - 1), rl] > 0.5. For each phase
// ph < P of g, valid = ph < g_n_phases[g]:
// mode 0: pressure[g, ph] = sum over available links of (start - end), -inf
//         where not valid, and the action = the first maximum (jnp.argmax:
//         all -inf gives 0); intersections g >= G (virtual) get action 0;
// mode 1: fw[g, ph] and fp[g, ph], the sums of start and of (start - end)
//         over available links (0 where not valid), and w_up[g], the sum of
//         start over all links.
//
// All of that but the waiting counts is static net structure, and the
// links of an intersection share few lanes (36 links over 24 lanes at a
// 30x30 grid's). The wrapper (kernels/phase_pressure.lane_tables) derives
// once per net, for each intersection g, its distinct lanes and per lane
// the counts of g's links that start there (cup), that start there and
// are available in phase ph (cs[ph]), and cs[ph] less those that end there
// (cp[ph]), for every ph < MAX_P = 64. Then
//   w_up = sum cup * w,   fw[ph] = sum cs[ph] * w,   fp[ph] = sum cp[ph] * w
// over g's lanes. Every product and sum is of small integers in float32:
// exact in any order (a fused multiply-add included), and never -0.0 (each
// sum starts at +0.0 and adds exact products), so the outputs equal the
// per-link sums bit for bit.
//
// Layout: a block of TB envs (32 from B = 32 on, else B rounded up to a
// power of two) by GY = 128 / TB intersections; a warp reads one 128-byte
// line of w (N, B) for a lane. The block stages its intersections' lanes
// and their counts for PC = 16 phases in shared memory (converted to float
// once there, not in every thread), ECH lanes of each at a time; a thread
// loads the waiting counts of a few lanes together, then adds their
// products into PC per-phase sums held in registers. P > 16 (up to MAX_P)
// takes ceil(P / 16) passes, the later ones reading w from the cache. The
// argmax carries across passes.
//
// Bound: bytes. Each lane's count once per env, the lane tables once, and
// the outputs.
#include "common.cuh"

#define MAX_P 64
#define PC 16             // phases summed in registers per pass
#define CW 136            // int16 words a lane's counts take (see CS, CP)
#define CS 8              // cs[ph] at word CS + ph (cup at word 0)
#define CP 72             // cp[ph] at word CP + ph
#define PP_THREADS 128
#define PP_STAGE 128      // lanes staged per block
// lanes whose counts a thread loads together, and the resident blocks an
// SM ptxas plans for, in mode 0 / mode 1 (at 8 blocks mode 1's 32 sums
// fit 64 registers: one wave of blocks at a 30x30 grid's B = 128)
#define PP_U0 4
#define PP_U1 2
#define PP_MINB0 1
#define PP_MINB1 8

struct PhasePressureArgs {
  int mode;                // 0 pressures + actions, 1 features
  const int* w;            // (N, B) waiting per lane
  const int* lanes;        // (G, E) each intersection's lanes, -1 pads
  const short* coef;       // (G, E, CW) their counts
  const int* g_nph;        // (G,) g_n_phases
  long long G, I, E, N, B;
  int P;
  float* press;            // (G, P, B)      mode 0
  int* actions;            // (I, B)         mode 0
  float* fw;               // (G, P, B)      mode 1
  float* fp;               // (G, P, B)      mode 1
  float* w_up;             // (G, B)         mode 1
};

__device__ __forceinline__ float lane_w(const int* __restrict__ w, int lane,
                                        long long N, long long B,
                                        long long b) {
  return (lane >= 0 && lane < N) ? (float)__ldg(&w[lane * B + b]) : 0.0f;
}

// the 8 int16 counts of an int4 as floats, into dst[0..8)
__device__ __forceinline__ void unpack8(float* dst, int4 q) {
  const int v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = (float)(short)v[i];
    dst[2 * i + 1] = (float)(v[i] >> 16);
  }
}

// acc[k] += c[k] * x, k < PC. Counts and waiting counts are integers and
// so is every product and sum (well inside 2^24): the fused multiply-add
// rounds nothing, so it gives what a multiply then an add would.
__device__ __forceinline__ void madd(float* acc, const float* c, float x) {
#pragma unroll
  for (int k = 0; k < PC; ++k) acc[k] = __fmaf_rn(c[k], x, acc[k]);
}

template <int MODE>
__global__ void __launch_bounds__(PP_THREADS,
                                  MODE == 1 ? PP_MINB1 : PP_MINB0)
    phase_pressure_kernel(const PhasePressureArgs a, int TB) {
  __shared__ int s_lane[PP_STAGE];
  __shared__ float s_cup[PP_STAGE];
  __shared__ __align__(16) float s_cp[PP_STAGE][PC];
  __shared__ __align__(16) float s_cs[MODE == 1 ? PP_STAGE : 1][PC];
  const int GY = PP_THREADS / TB;
  const int ECH = PP_STAGE / GY;            // lanes staged per row
  const int tx = threadIdx.x % TB, ty = threadIdx.x / TB;
  const long long rows = MODE == 0 ? a.I : a.G;
  const long long g0 = (long long)blockIdx.x * GY;
  const long long g = g0 + ty;
  const long long b = (long long)blockIdx.y * TB + tx;
  const bool env = b < a.B;
  if (MODE == 0 && env && g >= a.G && g < rows)
    a.actions[g * a.B + b] = 0;             // a virtual intersection
  const bool active = env && g < a.G;
  const int nph = active ? a.g_nph[g] : 0;
  const int* __restrict__ w = a.w;
  // staged parts of a lane: its id, cp's two words, cs's two, cup
  const int parts = MODE == 1 ? 6 : 3;
  float best = 0.0f;
  int best_ph = 0;
  for (int base = 0; base < a.P; base += PC) {
    float sw[PC], sp[PC];
#pragma unroll
    for (int k = 0; k < PC; ++k) sw[k] = sp[k] = 0.0f;
    float up = 0.0f;
    for (long long e0 = 0; e0 < a.E; e0 += ECH) {
      const int nc = (int)(a.E - e0 < ECH ? a.E - e0 : ECH);
      __syncthreads();
      // the counts of this pass's PC phases, as floats
      for (int q = threadIdx.x; q < GY * ECH * parts; q += PP_THREADS) {
        const int i = q / parts, part = q % parts;
        const int r = i / ECH, j = i % ECH;
        if (j >= nc || g0 + r >= a.G) continue;
        const long long e = (g0 + r) * a.E + e0 + j;
        const int4* c = reinterpret_cast<const int4*>(a.coef + e * CW);
        if (part == 0)
          s_lane[i] = a.lanes[e];
        else if (part <= 2)
          unpack8(&s_cp[i][8 * (part - 1)], c[(CP + base) / 8 + part - 1]);
        else if (part <= 4)
          unpack8(&s_cs[i][8 * (part - 3)], c[(CS + base) / 8 + part - 3]);
        else
          s_cup[i] = (float)a.coef[e * CW];
      }
      __syncthreads();
      if (!active) continue;
      const int i0 = ty * ECH;
      constexpr int U = MODE == 1 ? PP_U1 : PP_U0;
      for (int j = 0; j < nc; j += U) {
        float x[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          x[u] = j + u < nc ? lane_w(w, s_lane[i0 + j + u], a.N, a.B, b)
                            : 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u >= nc) break;
          const int i = i0 + j + u;
          madd(sp, s_cp[i], x[u]);
          if (MODE == 1) {
            madd(sw, s_cs[i], x[u]);
            up = __fmaf_rn(s_cup[i], x[u], up);
          }
        }
      }
    }
    if (!active) continue;
    if (MODE == 1 && base == 0) a.w_up[g * a.B + b] = up;
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      const int ph = base + k;
      if (ph >= a.P) break;
      const bool valid = ph < nph;
      const long long o = (g * a.P + ph) * a.B + b;
      if (MODE == 1) {
        a.fw[o] = valid ? sw[k] : 0.0f;
        a.fp[o] = valid ? sp[k] : 0.0f;
      } else {
        const float p = valid ? sp[k] : -INFINITY;
        a.press[o] = p;
        if (ph == 0 || p > best) {
          best = p;
          best_ph = ph;
        }
      }
    }
  }
  if (MODE == 0 && active) a.actions[g * a.B + b] = best_ph;
}

extern "C" int phase_pressure(const PhasePressureArgs* args, void* stream) {
  const PhasePressureArgs& a = *args;
  if (a.mode < 0 || a.mode > 1 || a.P < 1 || a.P > MAX_P) return -1;
  const long long rows = a.mode == 0 ? a.I : a.G;
  if (rows == 0 || a.B == 0) return 0;
  int TB = 32;
  if (a.B < 32) {
    TB = 1;
    while (TB < a.B) TB <<= 1;
  }
  const int GY = PP_THREADS / TB;
  const long long gx = (rows + GY - 1) / GY;
  const long long gy = (a.B + TB - 1) / TB;
  if (gx > 0x7FFFFFFFLL || gy > 65535) return -1;
  dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  if (a.mode == 0)
    phase_pressure_kernel<0><<<grid, PP_THREADS, 0, s>>>(a, TB);
  else
    phase_pressure_kernel<1><<<grid, PP_THREADS, 0, s>>>(a, TB);
  return (int)cudaGetLastError();
}
