// K2 cross_caps: Cross::canPass for every (row, link, env) over the link's
// KC crosses (reference roadnet.cpp:604-660).
//
// Replaces cross_caps in cityflow_tpu/core/ring.py (:936-996), which the
// TPU evaluates as (R, KC, LPI, G) slabs in one fused loop. Here one thread
// owns one (r, lpi, g, b) and walks its KC crosses in distance order, so the
// (R, KC, ...) intermediates never reach device memory and the any-fail /
// first-fail reductions are register loops.
//
// The template mode (non-uniform vehicle templates, :942-954) reads each
// row's template index `tpl` and takes the subject's maxNegAcc, yield
// distance, length, turn speed, max speed and usualPosAcc from the (TP, 12)
// table (an index outside [0, TP) reads zeros, like the JAX one-hot
// einsum); its own instantiation, the uniform one unchanged.
//
// The foe exchange (:881-927, foe_perm / foe_gather) is read in place: a
// cross's 9 foe channels are fields[c, foe_src[kc * LK + col], b] of R1's
// notifier fields, so the (9, KC, LK, B) exchanged slab is never written.
// foe_src is one int per (cross, link), the same for the whole warp; a
// cross whose foe_src is -1 has no foe (the gathered slab holds +0.0
// there: foe_exists false, so it passes) and reads nothing.
//
// Bound: bytes. Per output it reads 5 row floats + the relevant flag and,
// per cross, 9 foe channels (36 bytes) plus the cross tables; the decision
// tree is ~60 float and integer operations per cross, far below the card's
// rate for that traffic. Threads run along b (contiguous env axis).
#include "common.cuh"

struct CrossCapsArgs {
  const float* dls;        // (R, LK, B)
  const float* speed;      // (R, LK, B)
  const float* ent;        // (R, LK, B) or null -> ent_val
  const float* ph;         // (R, LK, B) priority high half
  const float* plo;        // (R, LK, B) priority low half
  const uint8_t* relevant; // (R, LK, B)
  const float* d;          // (KC, LK) cross distance
  const uint8_t* cvalid;   // (KC, LK)
  const int* t2;           // (KC, LK) foe link type
  const int* foelpi;       // (KC, LK)
  const int* t1;           // (LK,) own link type
  const uint8_t* turn;     // (LK,)
  const float* fields;     // (9, NF, B) R1's notifier fields
  const int* foe_src;      // (KC, LK) fields row of each cross's foe, or -1
  uint8_t* any_fail;       // (R, LK, B)
  float* ff_d;             // (R, LK, B)
  int* ff_foe;             // (R, LK, B)
  long long R, KC, LK, B, NF;
  float ent_val;
  float maxneg, yld, len, turnspd, maxspd, upa, dt;
  const int* tpl;          // template mode: (R, LK, B), else null
  const float* table;      //   (TP, 12)
  int TP;
};

// parameter columns of the template table (compiler/net.py P_*)
enum { P_LEN = 1, P_MAXNEGACC = 4, P_USUALPOSACC = 5, P_MAXSPEED = 8,
       P_YIELD = 10, P_TURNSPEED = 11, P_N = 12 };

__device__ __forceinline__ float tparam(const CrossCapsArgs& a, int t,
                                        int col) {
  return (t >= 0 && t < a.TP) ? __ldg(&a.table[t * P_N + col]) : 0.0f;
}

template <bool TPL>
__global__ void cross_caps_kernel(const CrossCapsArgs a) {
  long long total = a.R * a.LK * a.B;
  long long chs = a.NF * a.B;  // fields channel stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long col = (e / a.B) % a.LK;
    float dls = a.dls[e];
    float speed = a.speed[e];
    float ent = a.ent ? a.ent[e] : a.ent_val;
    float ph = a.ph[e];
    float plo = a.plo[e];
    bool relevant = a.relevant[e] != 0;
    float maxneg = a.maxneg, yld = a.yld, len = a.len, turnspd = a.turnspd;
    float maxspd = a.maxspd, upa = a.upa;
    if (TPL) {
      int t = a.tpl[e];
      maxneg = tparam(a, t, P_MAXNEGACC);
      yld = tparam(a, t, P_YIELD);
      len = tparam(a, t, P_LEN);
      turnspd = tparam(a, t, P_TURNSPEED);
      maxspd = tparam(a, t, P_MAXSPEED);
      upa = tparam(a, t, P_USUALPOSACC);
    }
    int t1 = a.t1[col];
    float target = a.turn[col] ? turnspd : maxspd;
    bool any = false;
    float ffd = INFINITY;
    int ffo = -1;
    for (long long kc = 0; kc < a.KC; ++kc) {
      long long tk = kc * a.LK + col;
      float dk = a.d[tk];
      bool considered = a.cvalid[tk] && (dk >= dls) && relevant;
      if (!considered) continue;
      int src = __ldg(&a.foe_src[tk]);
      if (src < 0) continue;          // no foe: passes
      float d1 = dk - dls;
      const float* fo = a.fields + (long long)src * a.B + b;
      bool foe_exists = fo[0] > 0.5f;
      bool foe_yield = fo[chs] > 0.5f;
      bool foe_cleared = fo[2 * chs] > 0.5f;
      bool foe_cyc = fo[3 * chs] > 0.5f;
      float fr = fo[4 * chs];
      float fdist = fo[5 * chs];
      float fent = fo[6 * chs];
      float fph = fo[7 * chs];
      float fplo = fo[8 * chs];
      bool self_yield = can_yield(speed, maxneg, yld, len, d1);
      int sri = reach_steps(speed, d1, target, upa, a.dt);
      float sr = (float)(sri < 255 ? sri : 255);
      bool pri_win = (ph > fph) || ((ph == fph) && (plo > fplo));
      int same_rank_y =
          (fr > sr) ? -1
          : (fr < sr) ? 1
          : (ent == fent) ? ((d1 == fdist) ? (pri_win ? -1 : 1)
                                           : ((d1 < fdist) ? -1 : 1))
                          : ((ent < fent) ? -1 : 1);
      bool foe_dpos = fdist > 0.0f;
      int t_eq = foe_dpos ? same_rank_y : (foe_cleared ? -1 : 1);
      int t_lt_pre = foe_dpos ? ((fr > sr) ? -1 : 0) : (foe_cleared ? -1 : 0);
      int t_lt = (t_lt_pre == 0) ? 1 : t_lt_pre;
      int t2 = a.t2[tk];
      int y = (t1 > t2) ? -1 : ((t1 < t2) ? t_lt : t_eq);
      if (!foe_yield) y = 1;
      if (y == 1 && foe_cyc) y = -1;
      bool passes = !foe_exists || !self_yield || (y == -1);
      if (passes) continue;
      any = true;
      // crosses are distance-ascending; ties keep the largest foe lpi
      // (the reference's min distance, then max foe over equal distances)
      int fl = a.foelpi[tk];
      if (dk < ffd) {
        ffd = dk;
        ffo = fl;
      } else if (dk == ffd && fl > ffo) {
        ffo = fl;
      }
    }
    a.any_fail[e] = any;
    a.ff_d[e] = ffd;
    a.ff_foe[e] = ffo;
  }
}

extern "C" int cross_caps(const CrossCapsArgs* args, void* stream) {
  long long total = args->R * args->LK * args->B;
  if (total == 0) return 0;
  int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (args->tpl) {
    if (!args->table || args->TP < 1) return -1;
    cross_caps_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(*args);
  } else {
    cross_caps_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}
