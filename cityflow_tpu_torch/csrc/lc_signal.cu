// L1 lc_signal: SimpleLaneChange::makeSignal, the target lane's leader and
// follower, and the gap validity (reference lanechange.cpp:27-60, 151-220,
// lanechange.h:80), for every slot of the lane rings.
//
// Replaces the neighbour-ring part of lc_phase in
// cityflow_tpu/core/ring_lc.py (:192-311): there every query runs over
// whole (SL, LNp) slabs permuted to the inner and outer neighbour columns
// by the shift plan (_perm / perm_channels), and the rank counts and the
// leader / follower selects are SL-long where-chains. Here one thread owns
// one (slot, lane, env), reads the neighbour column by index
// (ln_inner / ln_outer), counts its rank there and reads the leader and
// follower slot directly.
//
// The template mode (non-uniform vehicle templates, ring_lc.py:173-311) is
// its own instantiation (TPL = true): each row's own length, maxNegAcc and
// maxSpeed come from its template (the ring's `tpl` channel and the
// (TP, 12) table), the target leader's length and the target follower's
// maxNegAcc from theirs, read at the neighbour slot, and each out-link
// tail candidate subtracts its own length (`olt_len`). The thresholds are
// float32 arithmetic on those parameters, as JAX computes them there:
// expected = 2 len + f32(4 interval) maxSpeed, 1.5 len.
//
// Bound: bytes. Each thread reads its own row (about 30 bytes), the
// neighbour rings' dis (both sides) and its route rows; the neighbour reads
// are shared by the SL threads of a column and hit L1/L2. No float work to
// speak of; the divisions and comparisons round as in the plain version
// (--fmad=false, IEEE division).
#include "common.cuh"

struct LcSignalArgs {
  const float* dis;      // (S, N, B)
  const float* speed;
  const int* n_l;        // (N, B)
  const uint8_t* sh;
  const uint8_t* chg;
  const int* dir;
  const float* gap;
  const uint8_t* last;
  const int* rnrow;      // (M, S, N, B)
  const float* olt_dis;  // (KOUT, N, B)
  const uint8_t* olt_ex;
  const float* now;      // (B,)
  const int* inner;      // (N,) neighbour lane column, -1: none
  const int* outer;
  const float* ln_len;   // (N,)
  const int* llocal;     // (N,)
  uint8_t* plan;         // outputs (S, N, B)
  uint8_t* hsig;
  uint8_t* gval;
  int* dirc;
  int* tl_slot;
  float* ygap;
  long long S, N, B;
  int M, KOUT;
  float len, neg, expected, len15, cooling;
  const int* tpl;        // template mode: (S, N, B) template index, else null
  const float* table;    //   (TP, 12)
  const float* olt_len;  //   (KOUT, N, B) out-link tail lengths
  int TP;
  float interval4;       //   f32(4 * interval)
};

// parameter columns of the template table (compiler/net.py P_*)
enum { P_LEN = 1, P_MAXNEGACC = 4, P_MAXSPEED = 8, P_N = 12 };

__device__ __forceinline__ float tparam(const LcSignalArgs& a, int t,
                                        int col) {
  return (t >= 0 && t < a.TP) ? __ldg(&a.table[t * P_N + col]) : 0.0f;
}

struct Nb {
  int cnt;
  bool lead_ex, foll_ex;
  float lead_dis, foll_dis, foll_spd;
  float lead_len, foll_neg;   // template mode: the leader's length, the
                              // follower's maxNegAcc (0 without one)
};

// leader (slot cnt - 1) and follower (slot cnt) of distance d in column q:
// cnt = #{occupied t: dis[t] >= d}
template <bool TPL>
__device__ __forceinline__ Nb probe(const LcSignalArgs& a, int q,
                                    long long b, float d) {
  Nb r;
  r.cnt = 0;
  r.lead_dis = 0.0f;
  r.foll_dis = 0.0f;
  r.foll_spd = 0.0f;
  r.lead_len = 0.0f;
  r.foll_neg = 0.0f;
  int nn = 0;
  if (q >= 0) {
    nn = a.n_l[q * a.B + b];
    for (int t = 0; t < nn; ++t)
      if (a.dis[(t * a.N + q) * a.B + b] >= d) ++r.cnt;
  }
  r.lead_ex = r.cnt > 0;
  r.foll_ex = r.cnt < nn;
  if (r.lead_ex) {
    long long l = ((r.cnt - 1) * a.N + q) * a.B + b;
    r.lead_dis = a.dis[l];
    if (TPL) r.lead_len = tparam(a, a.tpl[l], P_LEN);
  }
  if (r.foll_ex) {
    long long f = (r.cnt * a.N + q) * a.B + b;
    r.foll_dis = a.dis[f];
    r.foll_spd = a.speed[f];
    if (TPL) r.foll_neg = tparam(a, a.tpl[f], P_MAXNEGACC);
  }
  return r;
}

// the route row of lane index llocal + delta (-1 when it does not exist)
__device__ __forceinline__ int route_row(const LcSignalArgs& a, int lo,
                                         long long s, long long p,
                                         long long b) {
  if (lo < 0 || lo >= a.M) return -1;
  return a.rnrow[((lo * a.S + s) * a.N + p) * a.B + b];
}

template <bool TPL>
__global__ void lc_signal_kernel(const LcSignalArgs a) {
  long long total = a.S * a.N * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long p = (e / a.B) % a.N;
    long long s = e / (a.B * a.N);
    float d = a.dis[e];
    float v = a.speed[e];
    bool occ = s < a.n_l[p * a.B + b];
    bool shv = a.sh[e], chv = a.chg[e];
    float lane_left = a.ln_len[p] - d;
    int qo = a.outer[p], qi = a.inner[p];
    Nb no = probe<TPL>(a, qo, b, d);
    Nb ni = probe<TPL>(a, qi, b, d);
    // my own parameters and thresholds
    float len = a.len, neg = a.neg, expected = a.expected, len15 = a.len15;
    if (TPL) {
      int t = a.tpl[e];
      len = tparam(a, t, P_LEN);
      neg = tparam(a, t, P_MAXNEGACC);
      expected = 2.0f * len + a.interval4 * tparam(a, t, P_MAXSPEED);
      len15 = 1.5f * len;
    }

    // makeSignal (lanechange.cpp:151-184)
    bool mk = occ && !shv && !chv && (a.now[b] >= a.cooling);
    bool hs = mk || (occ && !shv && chv);
    float cur = a.gap[e];
    bool want = mk && (lane_left >= 30.0f) && !(cur > expected) &&
                !(cur < len15);
    int lo = a.llocal[p];
    bool lastv = a.last[e];
    bool reach_out = lastv || route_row(a, lo + 1, s, p, b) >= 0;
    bool reach_in = lastv || route_row(a, lo - 1, s, p, b) >= 0;
    float len_out = qo >= 0 ? a.ln_len[qo] : 0.0f;
    float len_in = qi >= 0 ? a.ln_len[qi] : 0.0f;
    bool outer_ok = want && qo >= 0 && reach_out;
    // estimateGap (lanechange.cpp:215-220): the leader's length
    float est_o = no.lead_ex ? (no.lead_dis - d) - (TPL ? no.lead_len : len)
                             : len_out - d;
    float outer_est = outer_ok ? est_o : 0.0f;
    int dir_new = (outer_ok && outer_est > cur + len) ? 1 : 0;
    bool inner_ok = want && qi >= 0 && reach_in;
    float inner_est = ni.lead_ex
        ? (ni.lead_dis - d) - (TPL ? ni.lead_len : len) : len_in - d;
    if (inner_ok && inner_est > cur + len && inner_est > outer_est)
      dir_new = -1;
    int dc = chv ? a.dir[e] : dir_new;
    bool pl = occ && !shv && ((hs && dc != 0) || chv);

    // updateLeaderAndFollower on the target side (lanechange.cpp:27-60)
    bool up = dc > 0;
    const Nb& T = up ? no : ni;
    int q = up ? qo : qi;
    float lgap = T.lead_ex ? (T.lead_dis - d) - (TPL ? T.lead_len : len)
                           : lane_left;
    if (!T.lead_ex) {
      // the target lane's out-link ring tails, running strict-min
      float best = INFINITY;
      for (int k = 0; k < a.KOUT; ++k) {
        long long o = (k * a.N + (q >= 0 ? q : 0)) * a.B + b;
        float c_dis = q >= 0 ? a.olt_dis[o] : 0.0f;
        bool c_ex = q >= 0 && a.olt_ex[o];
        // each candidate's own length (vehicle.cpp:174)
        float c_len = TPL ? (q >= 0 ? a.olt_len[o] : 0.0f) : len;
        float cgap = c_dis + lane_left;
        bool better = c_ex && (cgap < best);
        if (better && cgap < c_len) lgap = lane_left - (c_len - cgap);
        if (better) best = cgap;
      }
    }
    float fgap = T.foll_ex ? (d - T.foll_dis) - len : INFINITY;
    float min_brake = 0.5f * v * v / neg;
    // safeGapBefore: the follower's minBrake
    float safe = T.foll_ex
        ? 0.5f * T.foll_spd * T.foll_spd / (TPL ? T.foll_neg : neg) : 0.0f;

    a.plan[e] = pl;
    a.hsig[e] = hs;
    a.gval[e] = (lgap >= min_brake) && (fgap >= safe);
    a.dirc[e] = dc;
    a.tl_slot[e] = T.cnt - 1;
    a.ygap[e] = fgap - safe;
  }
}

extern "C" int lc_signal(const LcSignalArgs* args, void* stream) {
  long long total = args->S * args->N * args->B;
  if (total == 0) return 0;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (args->tpl) {
    if (!args->table || !args->olt_len || args->TP < 1) return -1;
    lc_signal_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(*args);
  } else {
    lc_signal_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}
