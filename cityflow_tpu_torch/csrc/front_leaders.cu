// R5 front_leaders: the leaders of the lane fronts, read from the link
// rings through the index tables.
//
// Replaces the KOUT min of cityflow_tpu/core/ring.py at both of its call
// sites and the leader bookkeeping around them: the approach rows
// (:1151-1300) and lc_front_ctx (:344-448). There each in-lane's KOUT
// out-link ring tails are one-hot gathered into a (C, IL, KOUT, G) slab,
// a strict min walks it (first k wins), and the front's next link's
// end-lane tail comes back through a from_link one-hot. Here one thread
// owns one (in-lane or lane, env) column and reads each out-link's ring
// tail in place (n_k - 1 of link out_src[...], its template's length from
// the table), so the slab is never written.
//
// mode 0, approach (every ring path): per front slot a < AP of in-lane
// (il, g) and env b, the inputs of K3's approach min_chain: gap, the
// leader's speed, has_lead, lane_left, the leader's template, and v_isr /
// isr_rel read back from the link domain at the slot's next link. For
// a = 0 the leader is the strict min over the out-link tails on
// kt_dis - len (subtracted before the compare), else the next link's
// end-lane tail; for a > 0 it is the in-lane's slot a - 1.
//
// mode 1, lc links (lane-change paths): per link, the end-lane tail
// (k_etd, k_ete, and k_etl with templates).
// mode 2, lc lanes: per lane, the min over the raw tail distances (the
// length subtracted after, uniform case; dis - len with templates), the
// out-link tails olt_* of lanechange.cpp:33-47, and the front's next link's
// length and end-lane tail (nlen, etd, ete, etl) read from mode 1's output.
//
// Every float op repeats the plain version's, in its order; a missing
// source (an index < 0, an empty ring) reads +0.0, as the gathers' fill.
//
// Bound: bytes. The tails read (one slot per out-link), the outputs
// written once.
#include "ring_regions.cuh"

struct FrontLeadersArgs {
  // link rings
  const float* k_dis;       // (SK, LKp, B)
  const float* k_speed;
  const int* k_tpl;         // null: uniform templates
  const int* n_k;           // (LKp, B)
  // lane rings (lc modes)
  const float* l_dis;       // (SL, LNp, B)
  const int* l_tpl;
  const int* l_nxt;
  const int* n_l;           // (LNp, B)
  // tables
  const int* out_src;       // (IL * KOUT * G,)
  const float* out_valid;   // (IL, KOUT, G)
  const int* in_src;        // (IL * G,)
  const int* in_inv;        // (LNp,)
  const int* end_src;       // (LKp,)
  const float* lk_len;      // (LKp,)
  const float* table;       // (TP, 12)
  // approach mode inputs
  const float* inl;         // (NFC * AP + 2, IL * G, B) forward exchange
  const float* et;          // (CE, LKp, B) end-lane tail bundle
  const float* v_isr_ap;    // (AP, LKp, B)
  const uint8_t* isr_rel_ap;
  // approach mode outputs, (AP, IL * G, B) each
  float* gap;
  float* lead_spd;
  uint8_t* has_lead;
  float* lane_left;
  float* v_isr;
  uint8_t* isr_rel;
  int* lead_tpl;            // templates only
  // lc link outputs, (LKp, B)
  float* k_etd;
  uint8_t* k_ete;
  float* k_etl;             // templates only
  // lc lane outputs, (LNp, B) and (KOUT, LNp, B)
  float* best_val;
  uint8_t* best_ex;
  float* nlen;
  float* etd;
  uint8_t* ete;
  float* etl;               // templates only
  float* olt_dis;
  uint8_t* olt_ex;
  float* olt_len;           // templates only
  long long SK, SL, LKp, LNp, IL, G, KOUT, LPI, AP, B, TP;
  long long ch_tpl;         // inl's template channel (templates only)
  long long nfc;            // inl's channels per slot
  float p_len;              // uniform vehicle length
};

namespace {

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// the local link index of next-link id `nxt` from in-lane column g, as
// ring.py lpi_of, then from_link_idx: the link row, or -1
__device__ __forceinline__ long long from_link(int nxt, long long g,
                                               const FrontLeadersArgs& a) {
  if (nxt < 0) return -1;
  const long long lpi = floor_div((long long)nxt - a.LNp - g, a.G);
  return (lpi >= 0 && lpi < a.LPI) ? lpi * a.G + g : -1;
}

// the ring tail of link lk in env b: (dis, speed, template, exists);
// +0.0 and template 0 for an empty ring
struct Tail {
  float dis, spd;
  int tpl;
  bool ex;
};

__device__ __forceinline__ Tail link_tail(const FrontLeadersArgs& a,
                                          long long lk, long long b) {
  Tail t{0.0f, 0.0f, 0, false};
  const int n = a.n_k[lk * a.B + b];
  if (n > 0) {
    const long long r = ((long long)(n - 1) * a.LKp + lk) * a.B + b;
    t.dis = a.k_dis[r];
    t.spd = a.k_speed[r];
    t.tpl = a.k_tpl ? a.k_tpl[r] : 0;
    t.ex = true;
  }
  return t;
}

__device__ __forceinline__ float len_of(const FrontLeadersArgs& a, int t) {
  return rr::tparam(a.table, a.TP, t, rr::P_LEN);
}

// ---- mode 0: approach ------------------------------------------------------

__global__ void approach_kernel(const FrontLeadersArgs a) {
  const long long ILG = a.IL * a.G;
  const long long total = ILG * a.B;
  const bool tpl = a.k_tpl != nullptr;
  const long long cs = ILG * a.B;            // inl / output channel stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long j = e / a.B;
    const long long il = j / a.G, g = j % a.G;
    const bool src_ok = a.in_src[j] >= 0;
    // inl channel c of front slot s
    auto ch = [&](long long c, long long s) {
      return a.inl[(c * a.AP + s) * cs + e];
    };
    const float il_len = a.inl[(a.nfc * a.AP) * cs + e];
    for (long long s = 0; s < a.AP; ++s) {
      const long long o = s * cs + e;
      const float h_dis = ch(0, s);
      const long long fidx = from_link(xla_f32_to_i32(ch(2, s)), g, a);
      const long long lr = fidx * a.B + b;   // (link, env) of the next link
      a.v_isr[o] = fidx >= 0 ? a.v_isr_ap[s * a.LKp * a.B + lr] : 0.0f;
      a.isr_rel[o] = fidx >= 0 ? a.isr_rel_ap[s * a.LKp * a.B + lr] : 0;
      const float lane_left = il_len - h_dis;
      a.lane_left[o] = lane_left;
      if (s > 0) {
        // the leader is the in-lane's slot s - 1
        const bool occ = ch(13, s - 1) > 0.0f && src_ok;
        const float l_dis = ch(0, s - 1);
        const int lt = tpl ? xla_f32_to_i32(ch(a.ch_tpl, s - 1)) : 0;
        const float llen = tpl ? len_of(a, lt) : a.p_len;
        a.has_lead[o] = occ;
        a.gap[o] = (l_dis - llen) - h_dis;
        a.lead_spd[o] = ch(1, s - 1);
        if (tpl) a.lead_tpl[o] = lt;
        continue;
      }
      // hop 1: the strict min over the out-link ring tails (first k wins)
      bool best_ex = false;
      float best_val = 0.0f, best_spd = 0.0f, best_tpl = 0.0f;
      for (long long k = 0; k < a.KOUT; ++k) {
        const long long oi = (il * a.KOUT + k) * a.G + g;
        const int lk = a.out_src[oi];
        if (lk < 0) continue;                  // fill: never a candidate
        const Tail t = link_tail(a, lk, b);
        const bool cand = t.ex && a.out_valid[oi] > 0.0f;
        const float v = t.dis - (tpl ? len_of(a, t.tpl) : a.p_len);
        if (cand && (!best_ex || v < best_val)) {
          best_val = v;
          best_spd = t.spd;
          best_tpl = (float)t.tpl;
        }
        best_ex = best_ex || cand;
      }
      // hop 2: the next link's end-lane tail
      float etd = 0.0f, ets = 0.0f, nlen = 0.0f;
      bool ete = false;
      int et_tpl = 0;
      if (fidx >= 0) {
        const long long ls = a.LKp * a.B;
        etd = a.et[0 * ls + lr];
        ets = a.et[2 * ls + lr];
        ete = a.et[5 * ls + lr] > 0.5f;
        if (tpl) et_tpl = xla_f32_to_i32(a.et[6 * ls + lr]);
        nlen = a.lk_len[fidx];
      }
      const float gap1 = lane_left + best_val;
      const float gap2 = ((lane_left + nlen) + etd) -
                         (tpl ? len_of(a, et_tpl) : a.p_len);
      a.has_lead[o] = best_ex || ete;
      a.gap[o] = best_ex ? gap1 : gap2;
      a.lead_spd[o] = best_ex ? best_spd : ets;
      if (tpl) a.lead_tpl[o] = best_ex ? xla_f32_to_i32(best_tpl) : et_tpl;
    }
  }
}

// ---- mode 1: lc, per link ----------------------------------------------------

__global__ void lc_links_kernel(const FrontLeadersArgs a) {
  const long long total = a.LKp * a.B;
  const bool tpl = a.l_tpl != nullptr;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long lk = e / a.B;
    const int ln = a.end_src[lk];
    float d = 0.0f, len = 0.0f;
    bool ex = false;
    if (ln >= 0) {
      const int n = a.n_l[(long long)ln * a.B + b];
      int t = 0;
      if (n > 0) {
        const long long r = ((long long)(n - 1) * a.LNp + ln) * a.B + b;
        d = a.l_dis[r];
        if (tpl) t = a.l_tpl[r];
        ex = true;
      }
      if (tpl) len = len_of(a, t);
    }
    a.k_etd[e] = d;
    a.k_ete[e] = ex;
    if (tpl) a.k_etl[e] = len;
  }
}

// ---- mode 2: lc, per lane ----------------------------------------------------

__global__ void lc_lanes_kernel(const FrontLeadersArgs a) {
  const long long total = a.LNp * a.B;
  const bool tpl = a.k_tpl != nullptr;
  const long long ks = a.LNp * a.B;          // olt_* stride over k
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long ln = e / a.B;
    const int i = a.in_inv[ln];
    if (i < 0) {                               // the gather's fill
      a.best_val[e] = 0.0f;
      a.best_ex[e] = 0;
      a.nlen[e] = 0.0f;
      a.etd[e] = 0.0f;
      a.ete[e] = 0;
      if (tpl) a.etl[e] = 0.0f;
      for (long long k = 0; k < a.KOUT; ++k) {
        a.olt_dis[k * ks + e] = 0.0f;
        a.olt_ex[k * ks + e] = 0;
        if (tpl) a.olt_len[k * ks + e] = 0.0f;
      }
      continue;
    }
    const long long il = i / a.G, g = i % a.G;
    bool best_ex = false;
    float best_raw = 0.0f;
    for (long long k = 0; k < a.KOUT; ++k) {
      const long long oi = (il * a.KOUT + k) * a.G + g;
      const int lk = a.out_src[oi];
      float d = 0.0f, len = 0.0f;
      bool ex = false;
      if (lk >= 0) {
        const Tail t = link_tail(a, lk, b);
        d = t.dis;
        ex = t.ex;
        if (tpl) len = len_of(a, t.tpl);
      }
      const bool cand = ex && a.out_valid[oi] > 0.0f;
      a.olt_dis[k * ks + e] = d;
      a.olt_ex[k * ks + e] = cand;
      if (tpl) a.olt_len[k * ks + e] = len;
      const float v = tpl ? d - len : d;
      if (cand && (!best_ex || v < best_raw)) best_raw = v;
      best_ex = best_ex || cand;
    }
    a.best_val[e] = tpl ? best_raw : best_raw - a.p_len;
    a.best_ex[e] = best_ex;
    // the front's next link: its length and end-lane tail (mode 1's rows)
    const int src = a.in_src[i];
    const int nxt =
        src >= 0 ? rr::via_f32(a.l_nxt[(long long)src * a.B + b]) : 0;
    const long long fidx = from_link(nxt, g, a);
    const long long lr = fidx * a.B + b;
    a.nlen[e] = fidx >= 0 ? a.lk_len[fidx] : 0.0f;
    a.etd[e] = fidx >= 0 ? a.k_etd[lr] : 0.0f;
    a.ete[e] = fidx >= 0 ? a.k_ete[lr] : 0;
    if (tpl) a.etl[e] = fidx >= 0 ? a.k_etl[lr] : 0.0f;
  }
}

}  // namespace

extern "C" int front_leaders(const FrontLeadersArgs* args, int mode,
                             void* stream) {
  const FrontLeadersArgs a = *args;
  const int threads = 128;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.B == 0) return 0;
  if ((a.k_tpl || a.l_tpl) && (!a.table || a.TP < 1)) return -1;
  if (mode == 0) {
    if (a.IL * a.G == 0) return 0;
    approach_kernel<<<rr::grid_for(a.IL * a.G * a.B, threads), threads, 0,
                      st>>>(a);
  } else if (mode == 1) {
    if (a.LKp == 0) return 0;
    lc_links_kernel<<<rr::grid_for(a.LKp * a.B, threads), threads, 0, st>>>(
        a);
  } else if (mode == 2) {
    if (a.LNp == 0) return 0;
    lc_lanes_kernel<<<rr::grid_for(a.LNp * a.B, threads), threads, 0, st>>>(
        a);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
