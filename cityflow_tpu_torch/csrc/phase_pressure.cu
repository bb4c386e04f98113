// O2 phase_pressure: MaxPressure per candidate phase, the DQN's per-phase
// features and the MaxPressure action, one thread per (intersection, env).
//
// Replaces phase_pressures, phase_features and max_pressure_phases_ring in
// cityflow_tpu/core/ring_observe.py (:35-112). There the waiting counts go
// through the forward exchange and three typed one-hot einsums (E_start,
// E_end, E_rl) once per phase, an (LPI, G) slab each. Here the thread of
// intersection g walks its LPI links: the start lane's waiting count comes
// through in_src(start_src(l, g)), the end lane's through end_src(l, g), the
// roadlink through rl_src(l, g) (-1 reads 0 everywhere). For each phase
// ph < P of g:
//   avail = phase_rl_avail[clip(g_phase_offset[g] + ph, 0, TP - 1), rl] > 0.5
//   valid = ph < g_n_phases[g]
// mode 0: pressure[g, ph] = sum over available links of (start - end), -inf
//         where not valid, and the action = the first maximum (jnp.argmax:
//         all -inf gives 0); intersections g >= G (virtual) get action 0;
// mode 1: fw[g, ph] and fp[g, ph], the sums of start and of (start - end)
//         over available links (0 where not valid), and w_up[g], the sum of
//         start over all links.
// Every value is a sum of small integers in float32: exact in any order.
//
// Bound: bytes. The waiting counts read once per (link, env), the index
// tables, and the outputs.
#include "common.cuh"

#define MAX_P 64

struct PhasePressureArgs {
  int mode;                // 0 pressures + actions, 1 features
  const int* w;            // (N, B) waiting per lane
  const int* start_src;    // (LPI * G,) in-lane row of each link's start
  const int* in_src;       // (IL * G,) lane of each in-lane row
  const int* end_src;      // (LPI * G,) lane of each link's end
  const int* rl_src;       // (LPI * G,) roadlink row, rl * G + g
  const float* avail;      // (TP, MAXRL) phase_rl_avail
  const int* g_off;        // (G,) g_phase_offset
  const int* g_nph;        // (G,) g_n_phases
  long long G, I, LPI, ILG, N, B, TP, MAXRL;
  int P;
  float* press;            // (G, P, B)      mode 0
  int* actions;            // (I, B)         mode 0
  float* fw;               // (G, P, B)      mode 1
  float* fp;               // (G, P, B)      mode 1
  float* w_up;             // (G, B)         mode 1
};

__device__ __forceinline__ float lane_w(const PhasePressureArgs& a, int lane,
                                        long long b) {
  return (lane >= 0 && lane < a.N) ? (float)a.w[lane * a.B + b] : 0.0f;
}

// start and end waiting of link (l, g)
__device__ __forceinline__ void link_w(const PhasePressureArgs& a,
                                       long long l, long long g, long long b,
                                       float* ws, float* we) {
  long long r = l * a.G + g;
  int s = a.start_src[r];
  int lane = (s >= 0 && s < a.ILG) ? a.in_src[s] : -1;
  *ws = lane_w(a, lane, b);
  *we = lane_w(a, a.end_src[r], b);
}

__device__ __forceinline__ bool link_avail(const PhasePressureArgs& a,
                                           long long l, long long g, int ph) {
  int src = a.rl_src[l * a.G + g];
  if (src < 0) return false;
  long long rl = src / a.G;
  long long col = src % a.G;
  long long row = (long long)a.g_off[col] + ph;
  row = row < 0 ? 0 : (row > a.TP - 1 ? a.TP - 1 : row);
  return a.avail[row * a.MAXRL + rl] > 0.5f;
}

__global__ void phase_pressure_kernel(const PhasePressureArgs a) {
  long long rows = a.mode == 0 ? a.I : a.G;
  long long total = rows * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long g = e / a.B;
    if (g >= a.G) {                       // mode 0: a virtual intersection
      a.actions[e] = 0;
      continue;
    }
    int nph = a.g_nph[g];
    if (a.mode == 1) {
      float up = 0.0f;
      for (long long l = 0; l < a.LPI; ++l) {
        float ws, we;
        link_w(a, l, g, b, &ws, &we);
        up += ws;
      }
      a.w_up[e] = up;
    }
    float best = 0.0f;
    int best_ph = 0;
    for (int ph = 0; ph < a.P; ++ph) {
      float sw = 0.0f, sp = 0.0f;
      for (long long l = 0; l < a.LPI; ++l) {
        if (!link_avail(a, l, g, ph)) continue;
        float ws, we;
        link_w(a, l, g, b, &ws, &we);
        sw += ws;
        sp += ws - we;
      }
      bool valid = ph < nph;
      long long o = (g * a.P + ph) * a.B + b;
      if (a.mode == 1) {
        a.fw[o] = valid ? sw : 0.0f;
        a.fp[o] = valid ? sp : 0.0f;
        continue;
      }
      float p = valid ? sp : -INFINITY;
      a.press[o] = p;
      if (ph == 0 || p > best) {
        best = p;
        best_ph = ph;
      }
    }
    if (a.mode == 0) a.actions[e] = best_ph;
  }
}

extern "C" int phase_pressure(const PhasePressureArgs* args, void* stream) {
  const PhasePressureArgs& a = *args;
  if (a.mode < 0 || a.mode > 1 || a.P < 1 || a.P > MAX_P) return -1;
  long long rows = a.mode == 0 ? a.I : a.G;
  long long total = rows * a.B;
  if (total == 0) return 0;
  int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  phase_pressure_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
