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
};

struct Nb {
  int cnt;
  bool lead_ex, foll_ex;
  float lead_dis, foll_dis, foll_spd;
};

// leader (slot cnt - 1) and follower (slot cnt) of distance d in column q:
// cnt = #{occupied t: dis[t] >= d}
__device__ __forceinline__ Nb probe(const LcSignalArgs& a, int q,
                                    long long b, float d) {
  Nb r;
  r.cnt = 0;
  r.lead_dis = 0.0f;
  r.foll_dis = 0.0f;
  r.foll_spd = 0.0f;
  int nn = 0;
  if (q >= 0) {
    nn = a.n_l[q * a.B + b];
    for (int t = 0; t < nn; ++t)
      if (a.dis[(t * a.N + q) * a.B + b] >= d) ++r.cnt;
  }
  r.lead_ex = r.cnt > 0;
  r.foll_ex = r.cnt < nn;
  if (r.lead_ex) r.lead_dis = a.dis[((r.cnt - 1) * a.N + q) * a.B + b];
  if (r.foll_ex) {
    long long f = (r.cnt * a.N + q) * a.B + b;
    r.foll_dis = a.dis[f];
    r.foll_spd = a.speed[f];
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
    Nb no = probe(a, qo, b, d);
    Nb ni = probe(a, qi, b, d);

    // makeSignal (lanechange.cpp:151-184)
    bool mk = occ && !shv && !chv && (a.now[b] >= a.cooling);
    bool hs = mk || (occ && !shv && chv);
    float cur = a.gap[e];
    bool want = mk && (lane_left >= 30.0f) && !(cur > a.expected) &&
                !(cur < a.len15);
    int lo = a.llocal[p];
    bool lastv = a.last[e];
    bool reach_out = lastv || route_row(a, lo + 1, s, p, b) >= 0;
    bool reach_in = lastv || route_row(a, lo - 1, s, p, b) >= 0;
    float len_out = qo >= 0 ? a.ln_len[qo] : 0.0f;
    float len_in = qi >= 0 ? a.ln_len[qi] : 0.0f;
    bool outer_ok = want && qo >= 0 && reach_out;
    float est_o = no.lead_ex ? (no.lead_dis - d) - a.len : len_out - d;
    float outer_est = outer_ok ? est_o : 0.0f;
    int dir_new = (outer_ok && outer_est > cur + a.len) ? 1 : 0;
    bool inner_ok = want && qi >= 0 && reach_in;
    float inner_est = ni.lead_ex ? (ni.lead_dis - d) - a.len : len_in - d;
    if (inner_ok && inner_est > cur + a.len && inner_est > outer_est)
      dir_new = -1;
    int dc = chv ? a.dir[e] : dir_new;
    bool pl = occ && !shv && ((hs && dc != 0) || chv);

    // updateLeaderAndFollower on the target side (lanechange.cpp:27-60)
    bool up = dc > 0;
    const Nb& T = up ? no : ni;
    int q = up ? qo : qi;
    float lgap = T.lead_ex ? (T.lead_dis - d) - a.len : lane_left;
    if (!T.lead_ex) {
      // the target lane's out-link ring tails, running strict-min
      float best = INFINITY;
      for (int k = 0; k < a.KOUT; ++k) {
        long long o = (k * a.N + (q >= 0 ? q : 0)) * a.B + b;
        float c_dis = q >= 0 ? a.olt_dis[o] : 0.0f;
        bool c_ex = q >= 0 && a.olt_ex[o];
        float cgap = c_dis + lane_left;
        bool better = c_ex && (cgap < best);
        if (better && cgap < a.len) lgap = lane_left - (a.len - cgap);
        if (better) best = cgap;
      }
    }
    float fgap = T.foll_ex ? (d - T.foll_dis) - a.len : INFINITY;
    float min_brake = 0.5f * v * v / a.neg;
    float safe = T.foll_ex ? 0.5f * T.foll_spd * T.foll_spd / a.neg : 0.0f;

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
  lc_signal_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
