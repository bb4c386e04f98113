// G14 phase_scores: the gen-1 intersection pressures, MaxPressure's phase
// pressures and choice (Varaiya 2013: the phase whose available lanelinks
// carry the most upstream-minus-downstream waiting), and the DQN's
// per-phase features, for B envs at once.
//
// Replaces intersection_pressure in cityflow_tpu/core/observe.py (:38-45),
// phase_pressures and max_pressure_phases in cityflow_tpu/rl/policies.py
// (:15-54) and the feature loop of build_intersection_obs and the reward
// in cityflow_tpu/rl/dqn.py (:60-85, :143-150), which the TPU runs as one
// scatter-add over the lanelinks per phase (P of them). Here:
//   1. one thread per (env, lanelink) reads its two lanes' waiting counts
//      and adds its pressure (and upstream waiting) to its intersection,
//      or to each phase row that has the lanelink available: float atomics
//      of small integers, exact in any order while the sums stay below
//      2^24;
//   2. mode "phases": one thread per (env, intersection) takes the first
//      phase of strictly largest pressure, from -inf.
//
// Bound: bytes. The lanelink tables and two waiting counts per lanelink
// are read, the sums written once; the availability table is read P times
// per lanelink.
#include "gen1.cuh"

using namespace gen1;

enum { M_PRESSURE, M_PHASES, M_FEATURES };

struct ScoreArgs {
  const int* w;               // (B, L) waiting per lane
  const int* ll_start;        // (LL,)
  const int* ll_end;          // (LL,)
  const int* ll_inter;        // (LL,)
  const int* ll_rl_local;     // (LL,)
  const int* n_phases;        // (I,)
  const int* phase_offset;    // (I,)
  const uint8_t* avail;       // (TP, MRL)
  void* out0;   // pressure (B, I) | phase pressures (B, TP) | fw (B, I, P)
  void* out1;   // -               | best phase (B, I) i32   | fp (B, I, P)
  void* out2;   // -               | -                       | up (B, I)
  long long B, L, LL, I, TP, MRL, P, mode;
};

__global__ void score_links(const ScoreArgs a) {
  const long long b = blockIdx.y;
  const int* w = a.w + b * a.L;
  float* o0 = (float*)a.out0;
  float* o1 = (float*)a.out1;
  float* o2 = (float*)a.out2;
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       l < a.LL; l += (long long)gridDim.x * blockDim.x) {
    float ws = (float)w[clampll(a.ll_start[l], 0, a.L - 1)];
    float press = ws - (float)w[clampll(a.ll_end[l], 0, a.L - 1)];
    long long i = clampll(a.ll_inter[l], 0, a.I - 1);
    if (a.mode == M_PRESSURE) {
      atomicAdd(&o0[b * a.I + i], press);
      continue;
    }
    long long n = a.n_phases[i], base = a.phase_offset[i];
    for (long long p = 0; p < a.P && p < n; ++p) {
      long long idx = clampll((base + p) * a.MRL + a.ll_rl_local[l], 0,
                              a.TP * a.MRL - 1);
      if (!a.avail[idx]) continue;
      if (a.mode == M_PHASES) {
        atomicAdd(&o0[b * a.TP + base + p], press);
      } else {
        atomicAdd(&o0[(b * a.I + i) * a.P + p], ws);
        atomicAdd(&o1[(b * a.I + i) * a.P + p], press);
      }
    }
    if (a.mode == M_FEATURES) atomicAdd(&o2[b * a.I + i], ws);
  }
}

__global__ void score_best(const ScoreArgs a) {
  const long long b = blockIdx.y;
  const float* tp = (const float*)a.out0 + b * a.TP;
  int* best = (int*)a.out1 + b * a.I;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < a.I; i += (long long)gridDim.x * blockDim.x) {
    int bp = 0;
    float bv = -INFINITY;
    for (long long p = 0; p < a.P; ++p) {
      float v = tp[clampll(a.phase_offset[i] + p, 0, a.TP - 1)];
      if (p < a.n_phases[i] && v > bv) {
        bp = (int)p;
        bv = v;
      }
    }
    best[i] = bp;
  }
}

extern "C" int phase_scores(const ScoreArgs* args, void* stream) {
  const ScoreArgs& a = *args;
  if (a.B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (a.LL > 0)
    score_links<<<dim3(grid_blocks(a.LL, threads), (unsigned)a.B), threads,
                  0, st>>>(a);
  if (a.mode == M_PHASES && a.I > 0)
    score_best<<<dim3(grid_blocks(a.I, threads), (unsigned)a.B), threads, 0,
                 st>>>(a);
  return (int)cudaGetLastError();
}
