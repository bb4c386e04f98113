// L1 lc_signal: SimpleLaneChange::makeSignal, the target lane's leader and
// follower, and the gap validity (reference lanechange.cpp:27-60, 151-220,
// lanechange.h:80), for every slot of the lane rings.
//
// Replaces the neighbour-ring part of lc_phase in
// cityflow_tpu/core/ring_lc.py (:192-311): there every query runs over
// whole (SL, LNp) slabs permuted to the inner and outer neighbour columns
// by the shift plan (_perm / perm_channels), and the rank counts and the
// leader / follower selects are SL-long where-chains. Here a block owns one
// lane and a tile of TB envs (threadIdx.x, envs adjacent in memory), its
// threadIdx.y rows walking the slots:
//   1. the block stages the occupied dis of the lane's two neighbour
//      columns (ln_outer / ln_inner), TB envs each, in shared memory, and
//      marks each (column, env) whose staged dis is not non-increasing
//      (dis[t] >= dis[t + 1] fails somewhere, as it does at a NaN);
//   2. each slot counts its rank in each neighbour column, cnt = #{t < nn :
//      dis[t] >= d}: a binary search where the column is non-increasing
//      (the rows with dis[t] >= d are then a prefix), a linear count where
//      it is not. Both give the count the plain version's loop gives, for
//      any data; the leader is slot cnt - 1, the follower slot cnt;
//   3. makeSignal, the target side's leader gap (the out-link tails when
//      it has no leader), the follower's gap and the validity. Each field
//      is read where the plain version's result depends on it: the stale
//      gap where a signal can start, the last-road flag, the route rows
//      and the other side's leader where a change is wanted, l_dir on
//      changing rows; the target side's fields are selected by value, not
//      through a reference to one side's struct (which would put both in
//      local memory).
// Indices are 32-bit (the host checks that M * S * N * B fits): the lane
// and the env tile come from blockIdx.x by one division a thread, none a
// slot.
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
// Bound: bytes. Each slot's dis, speed, sh and chg (10 bytes), the
// neighbour columns' occupied dis once a block, the follower's speed, the
// stale gap, route rows and last-road flag where a signal can start; 15
// output bytes a slot. No
// float work to speak of; the divisions and comparisons round as in the
// plain version (--fmad=false, IEEE division).
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
  int S, N, B, M, KOUT;
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

constexpr int SG_THREADS = 256;
constexpr int SG_SMEM = 48 * 1024;   // the staged columns, at most (no opt-in)

// #{t < n : col[t * stride] >= d}; `sorted`: the column is non-increasing,
// so the rows that count are a prefix
__device__ __forceinline__ int rank_in(const float* col, int stride, int n,
                                       bool sorted, float d) {
  if (!sorted) {
    int c = 0;
    for (int t = 0; t < n; ++t) c += col[t * stride] >= d;
    return c;
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid * stride] >= d) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the route row of lane index lo (-1 when it does not exist)
__device__ __forceinline__ int route_row(const LcSignalArgs& a, int lo,
                                         int e, int SNB) {
  if (lo < 0 || lo >= a.M) return -1;
  return a.rnrow[lo * SNB + e];
}

template <bool TPL>
__global__ void __launch_bounds__(SG_THREADS)
lc_signal_kernel(const LcSignalArgs a, int nbt) {
  extern __shared__ float sdis[];    // (2, S, TB): outer, inner columns
  __shared__ int unsorted[2][32];
  const int TB = blockDim.x, SY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int S = a.S, N = a.N, B = a.B;
  const int p = blockIdx.x / nbt;
  const int b = (blockIdx.x - p * nbt) * TB + tx;
  const bool live = b < B;
  const int qo = a.outer[p], qi = a.inner[p];
  // the neighbours' occupancy as the plain version reads it (raw: the
  // follower exists below it) and the rows staged (within the ring)
  const int nno = live && qo >= 0 ? a.n_l[qo * B + b] : 0;
  const int nni = live && qi >= 0 ? a.n_l[qi * B + b] : 0;
  const int nco = min(max(nno, 0), S), nci = min(max(nni, 0), S);
  float* colo = sdis + tx;
  float* coli = sdis + S * TB + tx;
  if (ty == 0) {
    unsorted[0][tx] = 0;
    unsorted[1][tx] = 0;
  }
  for (int t = ty; t < nco; t += SY) colo[t * TB] = a.dis[(t * N + qo) * B + b];
  for (int t = ty; t < nci; t += SY) coli[t * TB] = a.dis[(t * N + qi) * B + b];
  __syncthreads();
  for (int t = ty; t + 1 < nco; t += SY)
    if (!(colo[t * TB] >= colo[(t + 1) * TB])) unsorted[0][tx] = 1;
  for (int t = ty; t + 1 < nci; t += SY)
    if (!(coli[t * TB] >= coli[(t + 1) * TB])) unsorted[1][tx] = 1;
  __syncthreads();
  if (!live) return;
  const bool sorto = !unsorted[0][tx], sorti = !unsorted[1][tx];
  const int SNB = S * N * B;
  const int n_own = a.n_l[p * B + b];
  const float now = a.now[b];
  const float ln_len = a.ln_len[p];
  const float len_out = qo >= 0 ? a.ln_len[qo] : 0.0f;
  const float len_in = qi >= 0 ? a.ln_len[qi] : 0.0f;
  const int lo = a.llocal[p];
  for (int s = ty; s < S; s += SY) {
    const int e = (s * N + p) * B + b;
    const float d = a.dis[e];
    const float v = a.speed[e];
    const bool occ = s < n_own;
    const bool shv = a.sh[e], chv = a.chg[e];
    const float lane_left = ln_len - d;
    // my own parameters and thresholds
    float len = a.len, neg = a.neg, expected = a.expected, len15 = a.len15;
    if (TPL) {
      const int t = a.tpl[e];
      len = tparam(a, t, P_LEN);
      neg = tparam(a, t, P_MAXNEGACC);
      expected = 2.0f * len + a.interval4 * tparam(a, t, P_MAXSPEED);
      len15 = 1.5f * len;
    }

    // makeSignal (lanechange.cpp:151-184); the stale gap, the last-road
    // flag and the route rows count only where a signal can start
    const bool mk = occ && !shv && !chv && (now >= a.cooling);
    const bool hs = mk || (occ && !shv && chv);
    float cur = 0.0f;
    bool want = false;
    if (mk) {
      cur = a.gap[e];
      want = (lane_left >= 30.0f) && !(cur > expected) && !(cur < len15);
    }
    int dir_new = 0;
    if (want) {
      const bool lastv = a.last[e];
      const bool outer_ok =
          qo >= 0 && (lastv || route_row(a, lo + 1, e, SNB) >= 0);
      const bool inner_ok =
          qi >= 0 && (lastv || route_row(a, lo - 1, e, SNB) >= 0);
      // estimateGap (lanechange.cpp:215-220): the leader's length
      const int co = rank_in(colo, TB, nco, sorto, d);
      const int ci = rank_in(coli, TB, nci, sorti, d);
      const float l_o = TPL && co > 0
          ? tparam(a, a.tpl[((co - 1) * N + qo) * B + b], P_LEN) : len;
      const float l_i = TPL && ci > 0
          ? tparam(a, a.tpl[((ci - 1) * N + qi) * B + b], P_LEN) : len;
      const float est_o = co > 0 ? (colo[(co - 1) * TB] - d) - l_o
                                 : len_out - d;
      const float outer_est = outer_ok ? est_o : 0.0f;
      if (outer_ok && outer_est > cur + len) dir_new = 1;
      const float inner_est = ci > 0 ? (coli[(ci - 1) * TB] - d) - l_i
                                     : len_in - d;
      if (inner_ok && inner_est > cur + len && inner_est > outer_est)
        dir_new = -1;
    }
    const int dc = chv ? a.dir[e] : dir_new;
    const bool pl = occ && !shv && ((hs && dc != 0) || chv);

    // updateLeaderAndFollower on the target side (lanechange.cpp:27-60):
    // its rank, leader (slot cnt - 1) and follower (slot cnt)
    const bool up = dc > 0;
    const int q = up ? qo : qi;
    const float* col = up ? colo : coli;
    const int nc = up ? nco : nci;
    const int cnt = rank_in(col, TB, nc, up ? sorto : sorti, d);
    const bool tl_ex = cnt > 0;
    const bool tf_ex = cnt < (up ? nno : nni);
    float lgap = lane_left;
    if (tl_ex) {
      const float tl_len = TPL
          ? tparam(a, a.tpl[((cnt - 1) * N + q) * B + b], P_LEN) : len;
      lgap = (col[(cnt - 1) * TB] - d) - tl_len;
    } else {
      // the target lane's out-link ring tails, running strict-min
      float best = INFINITY;
      for (int k = 0; k < a.KOUT; ++k) {
        const int o = (k * N + (q >= 0 ? q : 0)) * B + b;
        const float c_dis = q >= 0 ? a.olt_dis[o] : 0.0f;
        const bool c_ex = q >= 0 && a.olt_ex[o];
        // each candidate's own length (vehicle.cpp:174)
        const float c_len = TPL ? (q >= 0 ? a.olt_len[o] : 0.0f) : len;
        const float cgap = c_dis + lane_left;
        const bool better = c_ex && (cgap < best);
        if (better && cgap < c_len) lgap = lane_left - (c_len - cgap);
        if (better) best = cgap;
      }
    }
    float tf_dis = 0.0f, tf_spd = 0.0f, tf_neg = 0.0f;
    if (tf_ex) {
      const int f = (min(cnt, S - 1) * N + q) * B + b;
      tf_dis = cnt < nc ? col[cnt * TB] : a.dis[f];
      tf_spd = a.speed[f];
      if (TPL) tf_neg = tparam(a, a.tpl[f], P_MAXNEGACC);
    }
    const float fgap = tf_ex ? (d - tf_dis) - len : INFINITY;
    const float min_brake = 0.5f * v * v / neg;
    // safeGapBefore: the follower's minBrake
    const float safe =
        tf_ex ? 0.5f * tf_spd * tf_spd / (TPL ? tf_neg : neg) : 0.0f;

    a.plan[e] = pl;
    a.hsig[e] = hs;
    a.gval[e] = (lgap >= min_brake) && (fgap >= safe);
    a.dirc[e] = dc;
    a.tl_slot[e] = cnt - 1;
    a.ygap[e] = fgap - safe;
  }
}

extern "C" int lc_signal(const LcSignalArgs* args, void* stream) {
  const LcSignalArgs& a = *args;
  const long long SNB = (long long)a.S * a.N * a.B;
  if (SNB == 0) return 0;
  if (SNB * (a.M > 0 ? a.M : 1) >= (1LL << 31) ||
      (long long)a.KOUT * a.N * a.B >= (1LL << 31))
    return -1;
  // an env tile of TB <= 32 (a power of two, no wider than B needs) whose
  // two staged columns fit the shared memory
  int TB = 1;
  while (TB < a.B && TB < 32) TB <<= 1;
  while (TB > 1 && 2LL * a.S * TB * (long long)sizeof(float) > SG_SMEM)
    TB >>= 1;
  const size_t smem = 2 * (size_t)a.S * TB * sizeof(float);
  if (smem > SG_SMEM) return -1;
  const int SY = max(1, min(SG_THREADS / TB, a.S));
  const int nbt = (a.B + TB - 1) / TB;
  const long long blocks = (long long)a.N * nbt;
  if (blocks >= (1LL << 31)) return -1;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 block(TB, SY);
  if (a.tpl) {
    if (!a.table || !a.olt_len || a.TP < 1) return -1;
    lc_signal_kernel<true><<<(unsigned)blocks, block, smem, st>>>(a, nbt);
  } else {
    lc_signal_kernel<false><<<(unsigned)blocks, block, smem, st>>>(a, nbt);
  }
  return (int)cudaGetLastError();
}
