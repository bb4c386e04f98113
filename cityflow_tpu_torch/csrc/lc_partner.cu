// L4 lc_partner: each paired row's partner values by uid match in the
// partner lane column (real and shadow in lockstep, engine.cpp:195-243).
//
// Replaces partner_fetch in cityflow_tpu/core/ring_lc.py (:534-567): there
// the uid / shadow / occupancy channels and the C fetched channels are
// permuted to both neighbour columns (2 * (3 + C) slabs through the shift
// plan) and an SL-long where-chain selects the first match. Here one thread
// owns one (slot, lane, env), picks the partner column (a real looks toward
// l_dir, a shadow toward -l_dir), walks its occupied slots to the first one
// with the same uid and the other shadow flag, and reads the C channels
// there.
//
// Bound: bytes. The row's own uid / sh / dir / chg and the C outputs, plus
// the partner column's uid / sh up to the match (shared by the SL threads
// of a column through L1/L2).
#include "common.cuh"

#define MAX_C 4

struct LcPartnerArgs {
  const int* uid;        // (S, N, B)
  const uint8_t* sh;
  const int* dir;
  const int* n_l;        // (N, B)
  const uint8_t* chg;
  const float* ch[MAX_C];  // (S, N, B) each
  int C;
  float* out;            // (C, S, N, B)
  uint8_t* found;        // (S, N, B)
  const int* inner;      // (N,)
  const int* outer;
  long long S, N, B;
};

__global__ void lc_partner_kernel(const LcPartnerArgs a) {
  long long total = a.S * a.N * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long p = (e / a.B) % a.N;
    long long s = e / (a.B * a.N);
    bool shv = a.sh[e];
    int d = a.dir[e];
    int look = shv ? -d : d;
    int q = look > 0 ? a.outer[p] : a.inner[p];
    int my_uid = a.uid[e];
    long long hit = -1;
    if (q >= 0) {
      int nq = a.n_l[q * a.B + b];
      for (long long t = 0; t < nq; ++t) {
        long long f = (t * a.N + q) * a.B + b;
        if (a.uid[f] == my_uid && ((a.sh[f] != 0) != shv)) {
          hit = f;
          break;
        }
      }
    }
    for (int c = 0; c < a.C; ++c)
      a.out[c * total + e] = hit >= 0 ? a.ch[c][hit] : 0.0f;
    bool occ = s < a.n_l[p * a.B + b];
    bool paired = occ && ((a.chg[e] && !shv) || shv) && look != 0;
    a.found[e] = hit >= 0 && paired;
  }
}

extern "C" int lc_partner(const LcPartnerArgs* args, void* stream) {
  long long total = args->S * args->N * args->B;
  if (total == 0) return 0;
  if (args->C < 1 || args->C > MAX_C) return -1;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  lc_partner_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
