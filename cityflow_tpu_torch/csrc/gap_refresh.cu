// R6 gap_refresh: the lane-change step's stale-gap refresh (the end of the
// previous step's Vehicle::updateLeaderAndGap, engine.cpp:581).
//
// Replaces cityflow_tpu/core/ring_lc.py refresh_gaps (:99-158). There the
// leader of every slot comes from shifted copies of the rings (a TPU shift
// plan), and with templates from one-hot parameter gathers of the leader's
// length and the front's maxSpeed / usualNegAcc. Here one launch covers
// every lane slot and every link slot: slot s > 0 reads its leader in slot
// s - 1 in place, and its length from the template table; slot 0 reads
// R5's front context (best_*, nlen, etd / ete / etl per lane, k_etd /
// k_ete / k_etl per link) and keeps its stale gap where no leader is in
// reach. Each float op repeats the plain version's, in its order.
//
// Bound: bytes. Per slot the distance (and template) of the slot and its
// leader, the old gap at slot 0, the new gap written.
#include "ring_regions.cuh"

struct GapRefreshArgs {
  const float* l_dis;       // (SL, LNp, B)
  const float* l_gap;
  const int* l_nxt;         // slot 0 read
  const int* l_tpl;         // null: uniform
  const float* k_dis;       // (SK, LKp, B)
  const float* k_gap;
  const int* k_tpl;
  const float* ln_len;      // (LNp,)
  const float* lk_len;      // (LKp,)
  const float* table;       // (TP, 12)
  // R5's front context
  const uint8_t* best_ex;   // (LNp, B)
  const float* best_val;
  const uint8_t* ete;
  const float* nlen;
  const float* etd;
  const float* etl;         // templates only
  const uint8_t* k_ete;     // (LKp, B)
  const float* k_etd;
  const float* k_etl;       // templates only
  float* out_l;             // (SL, LNp, B)
  float* out_k;             // (SK, LKp, B)
  long long SL, LNp, SK, LKp, B, TP;
  float p_len;              // uniform: the vehicle length
  float bound;              // uniform: the leader-scan bound
  float dt;                 // templates: the interval, for the bound
};

__global__ void gap_refresh_kernel(const GapRefreshArgs a) {
  const long long nl = a.SL * a.LNp * a.B;
  const long long total = nl + a.SK * a.LKp * a.B;
  const bool tpl = a.l_tpl != nullptr;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (e < nl) {
      const long long row = a.LNp * a.B;
      const long long s = e / row;
      const long long r = e % row;           // (lane, env)
      const float dis = a.l_dis[e];
      if (s > 0) {
        const float len = tpl ? rr::tparam(a.table, a.TP, a.l_tpl[e - row],
                                           rr::P_LEN)
                              : a.p_len;
        a.out_l[e] = (a.l_dis[e - row] - len) - dis;
        continue;
      }
      const long long ln = r / a.B;
      const float left0 = a.ln_len[ln] - dis;
      const bool has_next = a.l_nxt[e] >= 0;
      const bool bex = a.best_ex[r] != 0;
      float bound = a.bound, etl = a.p_len;
      if (tpl) {
        const int t = a.l_tpl[e];
        const float ms = rr::tparam(a.table, a.TP, t, rr::P_MAXSPEED);
        const float una = rr::tparam(a.table, a.TP, t, rr::P_USUALNEGACC);
        bound = ms * ms / una / 2.0f + ms * a.dt * 2.0f;
        etl = a.etl[r];
      }
      const float nlen = a.nlen[r];
      const bool fresh1 = has_next && bex;
      const bool fresh2 = has_next && !bex && a.ete[r] != 0 &&
                          (left0 + nlen <= bound);
      const float g1 = left0 + a.best_val[r];
      const float g2 = ((left0 + nlen) + a.etd[r]) - etl;
      a.out_l[e] = fresh1 ? g1 : (fresh2 ? g2 : a.l_gap[e]);
    } else {
      const long long ek = e - nl;
      const long long row = a.LKp * a.B;
      const long long s = ek / row;
      const long long r = ek % row;          // (link, env)
      const float dis = a.k_dis[ek];
      if (s > 0) {
        const float len = tpl ? rr::tparam(a.table, a.TP, a.k_tpl[ek - row],
                                           rr::P_LEN)
                              : a.p_len;
        a.out_k[ek] = (a.k_dis[ek - row] - len) - dis;
        continue;
      }
      const float etl = tpl ? a.k_etl[r] : a.p_len;
      a.out_k[ek] = a.k_ete[r] ? ((a.lk_len[r / a.B] - dis) + a.k_etd[r]) - etl
                               : a.k_gap[ek];
    }
  }
}

extern "C" int gap_refresh(const GapRefreshArgs* args, void* stream) {
  const GapRefreshArgs a = *args;
  const long long total = (a.SL * a.LNp + a.SK * a.LKp) * a.B;
  if (total == 0) return 0;
  if (a.l_tpl && (!a.k_tpl || !a.table || a.TP < 1 || !a.etl || !a.k_etl))
    return -1;
  const int threads = 256;
  gap_refresh_kernel<<<rr::grid_for(total, threads), threads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
