// L2 lc_receive: sendSignal / receiveSignal arbitration, yieldSpeed and the
// change decision (reference vehicle.cpp:391-401, lanechange.cpp:186-206).
//
// Replaces the receiver loop of lc_phase in cityflow_tpu/core/ring_lc.py
// (:313-367): there 2 * SL where-steps over (SL, LNp) slabs of the sender
// bundles permuted to both neighbour columns. Here one thread owns one
// receiver (slot, lane, env) and scans the 2 * SL senders of its inner
// column (direction +1) and then its outer column (direction -1), slots
// ascending, keeping the first sender of highest priority whose target
// leader or follower slot is the receiver: the same ties as
// `better = cand & (~got | _pri_gt(...))`. The (hi, lo) priority halves of
// the JAX exchange compare like the signed priority itself.
//
// Bound: bytes. The receiver's own row and 2 * SL sender rows (about 20
// bytes each, shared by the SL receivers of a column through L1/L2); one
// noCollisionSpeed per receiver, IEEE sqrt and division as in the plain
// version.
#include "common.cuh"

struct LcReceiveArgs {
  const uint8_t* plan;    // (S, N, B) from L1
  const int* dirc;
  const int* tl_slot;
  const float* ygap;
  const uint8_t* hsig;
  const uint8_t* gval;
  const float* speed;     // state
  const int* pri;
  const int* n_l;         // (N, B)
  const uint8_t* chg;
  const int* inner;       // (N,)
  const int* outer;
  float* yv;              // outputs (S, N, B)
  uint8_t* do_change;
  long long S, N, B;
  float neg, dt;
};

__global__ void lc_receive_kernel(const LcReceiveArgs a) {
  long long total = a.S * a.N * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long p = (e / a.B) % a.N;
    int s = (int)(e / (a.B * a.N));
    bool got = false, role_f = false;
    int best_pri = 0;
    float best_spd = 0.0f, best_gap = 0.0f;
    for (int side = 0; side < 2; ++side) {
      int q = side == 0 ? a.inner[p] : a.outer[p];
      int want = side == 0 ? 1 : -1;
      if (q < 0) continue;
      for (long long t = 0; t < a.S; ++t) {
        long long f = (t * a.N + q) * a.B + b;
        if (!a.plan[f] || a.dirc[f] != want) continue;
        int tl = a.tl_slot[f];
        bool as_l = tl == s, as_f = tl + 1 == s;
        if (!(as_l || as_f)) continue;
        int pr = a.pri[f];
        if (!got || pr > best_pri) {
          best_pri = pr;
          role_f = as_f && !as_l;
          best_spd = a.speed[f];
          best_gap = a.ygap[f];
        }
        got = true;
      }
    }
    bool occ = s < a.n_l[p * a.B + b];
    bool chv = a.chg[e], hs = a.hsig[e];
    bool received = occ && !chv && got && !(hs && !(best_pri > a.pri[e]));
    float vy = no_collision_speed(best_spd, a.neg, a.speed[e], a.neg,
                                  best_gap, a.dt, 0.0f);
    if (vy < 0.0f) vy = 100.0f;
    a.yv[e] = (received && role_f) ? vy : 100.0f;
    a.do_change[e] = a.plan[e] && hs && !received && !chv && a.gval[e] &&
                     a.dirc[e] != 0;
  }
}

extern "C" int lc_receive(const LcReceiveArgs* args, void* stream) {
  long long total = args->S * args->N * args->B;
  if (total == 0) return 0;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  lc_receive_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
