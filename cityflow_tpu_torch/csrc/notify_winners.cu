// R1 notify_winners: each cross's notifier and its canPass terms, and the
// blocker-cycle flag of each link, written as the foe exchange's input
// (Engine::threadNotifyCross, engine.cpp:317-372, on the ring layout).
//
// Replaces the notify winners and the blocker doubling of
// cityflow_tpu/core/ring.py (:789-864, :866-879). There the candidate
// count is a broadcast-reduce over (SK, KC, LPI, G), the winner's channels
// a one-hot contraction over the slot axis, about ten where-chains
// broadcast (LPI, G) into (KC, LPI, G), the notifier's template
// parameters a one-hot einsum (T1 in the port) and the blocker walk k_cyc
// one-hot compositions; every intermediate is a full (KC, LPI, G) array
// in device memory. Here one thread owns one (link, env): it walks the
// blocker chain once, reads the end-lane tail and the start-lane head
// once, and for each of the KC crosses counts the occupied slots whose
// tail lies past the cross, takes the winner (end tail > ring slot >
// start head), computes the notifier's distance, can_yield, reach_steps
// and cleared flag with its own parameters, and writes the nine channels.
//
// out[f][c][lk][b], f = exists, yield, cleared, cycle, reach (<= 255),
// distance, enter time (min(k_entll, 2^25), 2^25 for tail / head), pri
// hi, pri lo.
//
// Bound: bytes. The nine (KC, LKp, B) float outputs (3.0 GB at 30x30,
// B=128) dominate; the rings, tails and heads are read once per link.
#include "ring_regions.cuh"

struct NotifyWinnersArgs {
  const float* k_dis;      // (SK, LKp, B)
  const float* k_speed;
  const int* k_entll;
  const int* k_pri;
  const int* k_tpl;        // template mode, else null
  const int* n_k;          // (LKp, B)
  const int* blk;          // (LKp, B) blocker foe lpi, -1
  const float* et;         // (6 [+1], LKp, B) end-lane tail bundle
  const float* st;         // (7 [+1], LKp, B) start-lane head bundle
  const uint8_t* avail;    // (LKp, B)
  const float* lk_d;       // (KC, LKp) cross distance
  const float* lk_len;     // (LKp,)
  const uint8_t* lk_turn;  // (LKp,)
  const float* table;      // (TP, 12)
  float* out;              // (9, KC, LKp, B)
  long long SK, LPI, G, KC, LNp, B, TP, k_cyc;
  float p_len, p_maxneg, p_yield, p_turnspd, p_maxspd, p_upa, dt;
};

template <bool TPL>
__global__ void notify_winners_kernel(const NotifyWinnersArgs a) {
  const long long LKp = a.LPI * a.G;
  const long long total = LKp * a.B;   // also the channel stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long lk = e / a.B;
    const long long g = lk % a.G;
    const int n = a.n_k[e];
    // blocker cycle: k_cyc hops after blk itself, -1 absorbing
    int f = a.blk[e];
    for (long long k = 0; k < a.k_cyc; ++k)
      f = (f >= 0 && f < a.LPI) ? a.blk[(f * a.G + g) * a.B + b] : -1;
    const float cyc = f >= 0 ? 1.0f : 0.0f;
    // end-lane tail and start-lane head of this link
    const float et_dis = a.et[e], et_spd = a.et[2 * total + e];
    const float et_ph = a.et[3 * total + e], et_pl = a.et[4 * total + e];
    const int et_prev = xla_f32_to_i32(a.et[total + e]);
    const bool et_ex = a.et[5 * total + e] > 0.5f;
    const int et_tpl = TPL ? xla_f32_to_i32(a.et[6 * total + e]) : 0;
    const float et_len =
        TPL ? rr::tparam(a.table, a.TP, et_tpl, rr::P_LEN) : a.p_len;
    const float s_dis = a.st[e], s_spd = a.st[2 * total + e];
    const float s_ph = a.st[3 * total + e], s_pl = a.st[4 * total + e];
    const int s_nxt = xla_f32_to_i32(a.st[total + e]);
    const bool s_occ = a.st[5 * total + e] > 0.5f;
    const float s_len = a.st[6 * total + e];
    const int s_tpl = TPL ? xla_f32_to_i32(a.st[7 * total + e]) : 0;
    const int lk_id = (int)(a.LNp + lk);
    const bool e_ok = et_ex && et_prev == lk_id;
    const float p_e = a.lk_len[lk] + et_dis;
    const float t_e = p_e - et_len;
    const bool s_ok = s_occ && s_nxt == lk_id && a.avail[e] != 0;
    const float p_s = s_dis - s_len;
    const bool turn = a.lk_turn[lk] != 0;
    for (long long c = 0; c < a.KC; ++c) {
      const float d = a.lk_d[c * LKp + lk];
      int cnt = 0;
      for (long long s = 0; s < a.SK && s < n; ++s) {
        const long long r = s * total + e;
        const float len =
            TPL ? rr::tparam(a.table, a.TP, a.k_tpl[r], rr::P_LEN) : a.p_len;
        cnt += (a.k_dis[r] - len) > d;
      }
      const bool ring_hit = cnt < n;
      const bool e_elig = e_ok && t_e < d;
      const bool use_start = !e_elig && !ring_hit && s_ok;
      float w_p = 0.0f, w_spd = 0.0f, w_ent = 0.0f, w_ph = 0.0f, w_pl = 0.0f;
      int w_tpl = 0;
      if (ring_hit) {
        const long long r = (cnt < a.SK ? cnt : a.SK - 1) * total + e;
        w_p = a.k_dis[r];
        w_spd = a.k_speed[r];
        const int ent = a.k_entll[r];
        w_ent = (float)(ent < (1 << 25) ? ent : (1 << 25));
        w_ph = rr::pri_hi(a.k_pri[r]);
        w_pl = rr::pri_lo(a.k_pri[r]);
        if (TPL) w_tpl = a.k_tpl[r];
      }
      if (use_start) {
        w_p = p_s; w_spd = s_spd; w_ent = (float)(1 << 25);
        w_ph = s_ph; w_pl = s_pl; w_tpl = s_tpl;
      }
      if (e_elig) {
        w_p = p_e; w_spd = et_spd; w_ent = (float)(1 << 25);
        w_ph = et_ph; w_pl = et_pl; w_tpl = et_tpl;
      }
      const bool exists = e_elig || ring_hit || use_start;
      float maxneg = a.p_maxneg, yld = a.p_yield, len = a.p_len;
      float turnspd = a.p_turnspd, maxspd = a.p_maxspd, upa = a.p_upa;
      if (TPL) {
        maxneg = rr::tparam(a.table, a.TP, w_tpl, rr::P_MAXNEGACC);
        yld = rr::tparam(a.table, a.TP, w_tpl, rr::P_YIELD);
        len = rr::tparam(a.table, a.TP, w_tpl, rr::P_LEN);
        turnspd = rr::tparam(a.table, a.TP, w_tpl, rr::P_TURNSPEED);
        maxspd = rr::tparam(a.table, a.TP, w_tpl, rr::P_MAXSPEED);
        upa = rr::tparam(a.table, a.TP, w_tpl, rr::P_USUALPOSACC);
      }
      const float ndist = d - w_p;
      const bool yield = can_yield(w_spd, maxneg, yld, len, ndist);
      const int reach =
          reach_steps(w_spd, ndist, turn ? turnspd : maxspd, upa, a.dt);
      const bool cleared = ndist + len < 0.0f;
      float* o = a.out + c * total + e;
      const long long fs = a.KC * total;   // field stride
      o[0] = exists ? 1.0f : 0.0f;
      o[fs] = yield ? 1.0f : 0.0f;
      o[2 * fs] = cleared ? 1.0f : 0.0f;
      o[3 * fs] = cyc;
      o[4 * fs] = (float)(reach < 255 ? reach : 255);
      o[5 * fs] = ndist;
      o[6 * fs] = w_ent;
      o[7 * fs] = w_ph;
      o[8 * fs] = w_pl;
    }
  }
}

extern "C" int notify_winners(const NotifyWinnersArgs* args, void* stream) {
  const NotifyWinnersArgs a = *args;
  const long long total = a.LPI * a.G * a.B;
  if (total == 0 || a.KC == 0) return 0;
  if (a.SK < 1) return -1;
  const int threads = 256;
  if (a.k_tpl)
    notify_winners_kernel<true><<<rr::grid_for(total, threads), threads, 0,
                                  (cudaStream_t)stream>>>(a);
  else
    notify_winners_kernel<false><<<rr::grid_for(total, threads), threads, 0,
                                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
