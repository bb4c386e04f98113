// K4 ring_commit: shift a ring column out by its front departures and
// append the column's entrants, for every channel in one pass.
//
// Replaces the link-ring commit (shift_out + append_k, 12 channels) and the
// lane-ring commit (stable sort of the A candidates by distance descending,
// then shift_out + append of at most SA of them) in
// cityflow_tpu/core/ring.py (:1644-1907). The TPU runs these as one masked
// select per (shift, channel) and a sorting network along A; here one
// thread owns one (column, env) and loops over slots and channels, so each
// ring value is read once and written once.
//
// Bound: bytes. Per (column, env): S slots x channels read and written, plus
// the entrant values; no arithmetic to speak of.
#include "common.cuh"

#define MAX_CH 16
#define MAX_A 16

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
};

__device__ __forceinline__ int hilo_to_i32(float h, float l) {
  return (int)(((unsigned)xla_f32_to_i32(h)) << 16) | xla_f32_to_i32(l);
}

__global__ void ring_commit_kernel(const RingCommitArgs a) {
  long long total = a.N * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long n = e / a.B;
    int x = a.x[e];
    int base = a.base[e];
    long long ac = -1;
    if (a.app_I == 0) {
      ac = n;
    } else {
      long long g = n % a.app_I;
      if (g < a.app_G) ac = (n / a.app_I) * a.app_G + g;
    }
    int sel[MAX_A];
    int pos[MAX_A];
    int nsel = 0;
    if (ac >= 0) {
      bool valid[MAX_A];
      for (int c = 0; c < a.A; ++c)
        valid[c] = a.app[((c * a.PCH + a.valid_ch) * a.AC + ac) * a.B + b] > 0.5f;
      if (a.sort_ch < 0) {
        for (int j = 0; j < a.nsel; ++j) sel[j] = j;
      } else {
        float key[MAX_A];
        bool used[MAX_A];
        for (int c = 0; c < a.A; ++c) {
          key[c] = valid[c]
              ? -a.app[((c * a.PCH + a.sort_ch) * a.AC + ac) * a.B + b]
              : INFINITY;
          used[c] = false;
        }
        for (int j = 0; j < a.nsel; ++j) {  // stable selection sort prefix
          int best = -1;
          for (int c = 0; c < a.A; ++c)
            if (!used[c] && (best < 0 || key[c] < key[best])) best = c;
          used[best] = true;
          sel[j] = best;
        }
      }
      int cnt = 0;
      for (int j = 0; j < a.nsel; ++j) {
        if (valid[sel[j]]) {
          pos[j] = base + cnt;
          ++cnt;
        } else {
          pos[j] = -1;
        }
      }
      nsel = a.nsel;
    }
    for (int ci = 0; ci < a.nch; ++ci) {
      const Chan& c = a.ch[ci];
      for (long long s = 0; s < a.S; ++s) {
        long long src = s + x;
        long long o = (s * a.N + n) * a.B + b;
        long long io = (src * a.N + n) * a.B + b;
        int hit = -1;
        for (int j = 0; j < nsel; ++j)
          if (pos[j] == s) hit = j;
        float av = 0.0f, av2 = 0.0f;
        if (hit >= 0) {
          long long cand = sel[hit];
          av = c.app_ch < 0 ? a.envval[b]
              : a.app[((cand * a.PCH + c.app_ch) * a.AC + ac) * a.B + b];
          if (c.kind == K_PRI)
            av2 = a.app[((cand * a.PCH + c.app_ch2) * a.AC + ac) * a.B + b];
        }
        bool in = src < a.S;
        if (c.kind == K_F32) {
          float v = in ? ((const float*)c.upd)[io] : c.fill;
          ((float*)c.out)[o] = hit >= 0 ? av : v;
        } else if (c.kind == K_I32) {
          int v = in ? ((const int*)c.upd)[io] : xla_f32_to_i32(c.fill);
          ((int*)c.out)[o] = hit >= 0 ? xla_f32_to_i32(av) : v;
        } else if (c.kind == K_BOOL) {
          uint8_t v = in ? ((const uint8_t*)c.upd)[io] : (c.fill > 0.5f);
          ((uint8_t*)c.out)[o] = hit >= 0 ? (uint8_t)(av > 0.5f) : v;
        } else {
          int v = in ? ((const int*)c.upd)[io] : hilo_to_i32(c.fill, c.fill);
          ((int*)c.out)[o] = hit >= 0 ? hilo_to_i32(av, av2) : v;
        }
      }
    }
  }
}

extern "C" int ring_commit(const RingCommitArgs* args, void* stream) {
  long long total = args->N * args->B;
  if (total == 0) return 0;
  if (args->nch > MAX_CH || args->A > MAX_A || args->nsel > args->A) return -1;
  int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  ring_commit_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
