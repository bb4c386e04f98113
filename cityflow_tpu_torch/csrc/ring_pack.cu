// R7 ring_pack: the channel packs between the ring kernels, written
// straight from the ring leaves into the buffer the next kernel reads.
//
// Replaces the shift plans and channel packs of cityflow_tpu/core/ring.py
// (_shifted_exchange / _fwd_ex, :300-341, and the packs of :686-729,
// :1644-1690, :1744-1837): there every channel is stacked into one slab,
// moved by a one-hot exchange (a TPU shift plan), and unpacked again.
// Here one thread owns one (destination row, env) column and reads each
// channel at its source row in place.
//
// mode 0, forward: the AP lane-front slots of in-lane j's lane in_src[j],
// channels dis, speed, nxt, nxt3, route, rpos, flow, pri hi, pri lo, uid,
// enter, custom, hascustom, occupied [, gap, yield speed] [, template],
// then the lane's length and maxSpeed: inl (NFC * AP + 2, IL * G, B), 0
// where in_src < 0.
// mode 1, entrant: per front slot a and link lk, the entrant of the link's
// start in-lane j = start_src[lk] when that front's next link is lk
// (to_link): valid, dis - in-lane length, speed, flow, route, rpos, enter,
// pri hi, pri lo, uid, nxt3 [, stale gap] [, template], all 0 unless the
// front exits this step into its next link: ent (AP, NE, LKp, B).
// mode 2, candidate: per exit slot xs, in-lane kin and lane row j, link
// app_src_g[kin][j]'s slot xs with its route rows: dis - link length,
// speed, flow, route, rpos + 1, enter, pri hi, pri lo, uid, nxt, nxt3,
// last, prev, valid [, gap, 0, rn.., ax..] [, template]: cands
// (KIN * XKe, NP, OL * G, B), 0 where the index is -1.
// mode 3, approach: per front slot a and link lk, the front of the link's
// start in-lane j = start_src[lk] when its next link is lk (to_link, as in
// mode 1), else +0.0 in every channel: the inputs of the approach rows'
// K2 and K3 calls, each in its own buffer. mine (the front is occupied and
// its in-lane has a lane), speed, pri hi, pri lo, dls = dis - st_len and
// lane_left = st_len - dis (st_len: the start in-lane's length, st's
// channel 6); with templates the template index, the approach distance
// ms ms / usualNegAcc / 2 + ms dt 2 and canEnter of the link's end lane
// for the front's own length (the template table read in place: no T1
// call). Replaces the to_link one-hot einsums of
// cityflow_tpu/core/ring.py:1154-1168 and their use at :1206-1231.
//
// Integers ride as float32 (int -> float rounding, as the plain packs'
// .to(float32)); priorities as their 16-bit halves.
//
// Bound: bytes. Every output written once, every channel read once (mode
// 3 reads each front's channels only where it heads into the link).
#include "ring_regions.cuh"

struct RingPackArgs {
  // lane rings (SL, LNp, B)
  const float* l_dis;
  const float* l_speed;
  const int* l_nxt;
  const int* l_nxt3;
  const int* l_route;
  const int* l_rpos;
  const int* l_flow;
  const int* l_pri;
  const int* l_uid;
  const float* l_enter;
  const float* l_custom;
  const uint8_t* l_hascustom;
  const float* l_gap;        // lane change only
  const float* l_yv;         // lane change only
  const int* l_tpl;          // templates only
  const int* n_l;            // (LNp, B)
  const float* ln_len;       // (LNp,)
  const float* ln_maxspd;
  const int* in_src;         // (IL * G,)
  float* inl;                // mode 0 output
  // mode 1
  const float* inl_in;       // the forward exchange (mode 0's output)
  const int* start_src;      // (LKp,)
  const uint8_t* exited;     // (XKl, LNp, B)
  const float* ap_dis;       // (AP, IL * G, B) (no lane change)
  const float* ap_spd;
  const float* new_dis_l;    // (SL, LNp, B) (lane change)
  const float* new_spd_l;
  float* ent;
  // mode 2, link rings (SK, LKp, B)
  const float* nd_k;
  const float* ns_k;
  const int* k_flow;
  const int* k_route;
  const int* k_rpos;
  const float* k_enter;
  const int* k_pri;
  const int* k_uid;
  const float* k_gap;        // lane change only
  const int* k_tpl;          // templates only
  const int* pays;           // (3 [+ 2 MAXLPR], XKe, LKp, B)
  const uint8_t* exit_flags; // (XKe, LKp, B)
  const float* lk_len;       // (LKp,)
  const int* app_src;        // (KIN, OL * G)
  float* cands;
  // mode 3
  const float* st_len;       // (LKp, B) the start in-lane's length
  const float* et;           // (NET, LKp, B) end-lane tails (templates)
  const float* table;        // (TP, 12) template parameters (templates)
  uint8_t* ap_mine;          // (AP, LKp, B)
  float* ap_f;               // (5 [+ 1], AP, LKp, B) speed, pri hi, pri
                             // lo, dls, lane_left [, approach]
  int* ap_tpl;               // (AP, LKp, B) (templates)
  uint8_t* ap_ce;            // (AP, LKp, B) (templates)
  long long SL, LNp, LKp, IL, G, AP, B, XKl, KIN, XKe, OLG, MAXLPR;
  long long nfc;             // inl channels per slot
  long long ch_tpl;          // inl's template channel (templates only)
  long long TP;              // template table rows (mode 3, templates)
  int lc;                    // lane change (the gap / yield channels)
  int tpl;                   // templates (the template channel)
  float dt;                  // the step interval (mode 3, templates)
};

namespace {

__device__ __forceinline__ float i2f(int v) { return (float)v; }

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// ---- mode 0: forward -------------------------------------------------------

__global__ void forward_kernel(const RingPackArgs a) {
  const long long ILG = a.IL * a.G;
  const long long total = ILG * a.B;
  const long long cs = ILG * a.B;            // output channel stride
  const long long ls = a.LNp * a.B;          // lane ring slot stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long j = e / a.B;
    const int src = a.in_src[j];
    float* o = a.inl + e;
    if (src < 0) {
      for (long long c = 0; c < a.nfc * a.AP + 2; ++c) o[c * cs] = 0.0f;
      continue;
    }
    const long long r = (long long)src * a.B + b;
    const int n = a.n_l[r];
    for (long long s = 0; s < a.AP; ++s) {
      const long long q = s * ls + r;
      auto put = [&](long long c, float v) { o[(c * a.AP + s) * cs] = v; };
      const int pri = a.l_pri[q];
      put(0, a.l_dis[q]);
      put(1, a.l_speed[q]);
      put(2, i2f(a.l_nxt[q]));
      put(3, i2f(a.l_nxt3[q]));
      put(4, i2f(a.l_route[q]));
      put(5, i2f(a.l_rpos[q]));
      put(6, i2f(a.l_flow[q]));
      put(7, rr::pri_hi(pri));
      put(8, rr::pri_lo(pri));
      put(9, i2f(a.l_uid[q]));
      put(10, a.l_enter[q]);
      put(11, a.l_custom[q]);
      put(12, a.l_hascustom[q] ? 1.0f : 0.0f);
      put(13, s < n ? 1.0f : 0.0f);
      if (a.lc) {
        put(14, a.l_gap[q]);
        put(15, a.l_yv[q]);
      }
      if (a.tpl) put(a.ch_tpl, i2f(a.l_tpl[q]));
    }
    o[(a.nfc * a.AP) * cs] = a.ln_len[src];
    o[(a.nfc * a.AP + 1) * cs] = a.ln_maxspd[src];
  }
}

// ---- mode 1: entrant -------------------------------------------------------

__global__ void entrant_kernel(const RingPackArgs a) {
  const long long ILG = a.IL * a.G;
  const long long total = a.LKp * a.B;
  const long long cs = ILG * a.B;            // inl channel stride
  const long long NE = 11 + (a.lc ? 1 : 0) + (a.tpl ? 1 : 0);
  const long long os = a.LKp * a.B;          // ent channel stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long lk = e / a.B;
    const int j = a.start_src[lk];
    const long long g = j >= 0 ? j % a.G : 0;
    for (long long s = 0; s < a.AP; ++s) {
      float* o = a.ent + s * NE * os + e;
      const long long q = (long long)j * a.B + b;  // (in-lane, env)
      auto ch = [&](long long c) { return a.inl_in[(c * a.AP + s) * cs + q]; };
      // to_link: the start in-lane's front s heads into this link
      bool to = false;
      int nxt = -1;
      if (j >= 0) {
        nxt = xla_f32_to_i32(ch(2));
        const long long lpi =
            nxt >= 0 ? floor_div((long long)nxt - a.LNp - g, a.G) : -1;
        to = lpi == lk / a.G;
      }
      bool ok = false;
      if (to) {
        const int src = a.in_src[j];
        const bool exited = src >= 0 && s < a.XKl &&
                            a.exited[(s * a.LNp + src) * a.B + b] != 0;
        const bool occ = ch(13) > 0.0f && src >= 0;
        ok = exited && occ && nxt >= 0;
      }
      if (!ok) {
        for (long long c = 0; c < NE; ++c) o[c * os] = 0.0f;
        continue;
      }
      const int src = a.in_src[j];
      const float il_len = a.inl_in[(a.nfc * a.AP) * cs + q];
      float dis, spd;
      if (a.lc) {
        const long long r = (s * a.LNp + src) * a.B + b;
        dis = a.new_dis_l[r] - il_len;
        spd = a.new_spd_l[r];
      } else {
        dis = a.ap_dis[s * cs + q] - il_len;
        spd = a.ap_spd[s * cs + q];
      }
      o[0] = 1.0f;
      o[1 * os] = dis;
      o[2 * os] = spd;
      o[3 * os] = ch(6);          // flow
      o[4 * os] = ch(4);          // route
      o[5 * os] = ch(5);          // rpos
      o[6 * os] = ch(10);         // enter
      o[7 * os] = ch(7);          // pri hi
      o[8 * os] = ch(8);          // pri lo
      o[9 * os] = ch(9);          // uid
      o[10 * os] = ch(3);         // nxt3
      long long c = 11;
      if (a.lc) o[(c++) * os] = ch(14);           // stale gap
      if (a.tpl) o[c * os] = ch(a.ch_tpl);
    }
  }
}

// ---- mode 2: candidate -----------------------------------------------------

__global__ void candidate_kernel(const RingPackArgs a) {
  const long long total = a.OLG * a.B;
  const long long NP =
      14 + (a.lc ? 2 + 2 * a.MAXLPR : 0) + (a.tpl ? 1 : 0);
  const long long os = a.OLG * a.B;          // cands channel stride
  const long long ks = a.LKp * a.B;          // link ring slot stride
  const long long ps = a.XKe * ks;           // pays channel stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long j = e / a.B;
    for (long long kin = 0; kin < a.KIN; ++kin) {
      const int lk = a.app_src[kin * a.OLG + j];
      for (long long xs = 0; xs < a.XKe; ++xs) {
        float* o = a.cands + (kin * a.XKe + xs) * NP * os + e;
        if (lk < 0) {
          for (long long c = 0; c < NP; ++c) o[c * os] = 0.0f;
          continue;
        }
        const long long q = xs * ks + (long long)lk * a.B + b;
        const int pri = a.k_pri[q];
        o[0] = a.nd_k[q] - a.lk_len[lk];
        o[1 * os] = a.ns_k[q];
        o[2 * os] = i2f(a.k_flow[q]);
        o[3 * os] = i2f(a.k_route[q]);
        o[4 * os] = i2f(a.k_rpos[q] + 1);
        o[5 * os] = a.k_enter[q];
        o[6 * os] = rr::pri_hi(pri);
        o[7 * os] = rr::pri_lo(pri);
        o[8 * os] = i2f(a.k_uid[q]);
        o[9 * os] = i2f(a.pays[q]);
        o[10 * os] = i2f(a.pays[ps + q]);
        o[11 * os] = a.pays[2 * ps + q] > 0 ? 1.0f : 0.0f;
        o[12 * os] = i2f((int)(a.LNp + lk));
        o[13 * os] = a.exit_flags[q] ? 1.0f : 0.0f;
        long long c = 14;
        if (a.lc) {
          o[(c++) * os] = a.k_gap[q];
          o[(c++) * os] = 0.0f;
          for (long long m = 0; m < 2 * a.MAXLPR; ++m)
            o[(c++) * os] = i2f(a.pays[(3 + m) * ps + q]);
        }
        if (a.tpl) o[c * os] = i2f(a.k_tpl[q]);
      }
    }
  }
}

// ---- mode 3: approach ------------------------------------------------------

__global__ void approach_kernel(const RingPackArgs a) {
  const long long ILG = a.IL * a.G;
  const long long total = a.LKp * a.B;
  const long long cs = ILG * a.B;            // inl channel stride
  const long long os = a.AP * total;         // ap_f channel stride
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e % a.B;
    const long long lk = e / a.B;
    const int j = a.start_src[lk];
    const long long g = j >= 0 ? j % a.G : 0;
    const long long q = (long long)j * a.B + b;    // (in-lane, env)
    const float stl = a.st_len[e];
    // the link's end-lane tail: dis, speed, exists, template (et 0 / 2 /
    // 5 / 6), for canEnter
    float etd = 0.0f, ets = 0.0f, etl = 0.0f;
    bool ete = false;
    if (a.tpl) {
      etd = a.et[e];
      ets = a.et[2 * total + e];
      ete = a.et[5 * total + e] > 0.5f;
      etl = rr::tparam(a.table, a.TP, xla_f32_to_i32(a.et[6 * total + e]),
                       rr::P_LEN);
    }
    for (long long s = 0; s < a.AP; ++s) {
      auto ch = [&](long long c) { return a.inl_in[(c * a.AP + s) * cs + q]; };
      // to_link: the start in-lane's front s heads into this link
      bool to = false;
      if (j >= 0) {
        const int nxt = xla_f32_to_i32(ch(2));
        const long long lpi =
            nxt >= 0 ? floor_div((long long)nxt - a.LNp - g, a.G) : -1;
        to = lpi == lk / a.G;
      }
      float dis = 0.0f, spd = 0.0f, ph = 0.0f, pl = 0.0f, tf = 0.0f;
      bool mine = false;
      if (to) {       // the next link is lk, so nxt >= 0
        mine = ch(13) > 0.0f && a.in_src[j] >= 0;
        dis = ch(0);
        spd = ch(1);
        ph = ch(7);
        pl = ch(8);
        if (a.tpl) tf = ch(a.ch_tpl);
      }
      const long long o = s * total + e;
      a.ap_mine[o] = mine;
      a.ap_f[o] = spd;
      a.ap_f[os + o] = ph;
      a.ap_f[2 * os + o] = pl;
      a.ap_f[3 * os + o] = dis - stl;
      a.ap_f[4 * os + o] = stl - dis;
      if (a.tpl) {
        const int t = rr::via_f32(xla_f32_to_i32(tf));
        const float ms = rr::tparam(a.table, a.TP, t, rr::P_MAXSPEED);
        const float una = rr::tparam(a.table, a.TP, t, rr::P_USUALNEGACC);
        const float len = rr::tparam(a.table, a.TP, t, rr::P_LEN);
        a.ap_tpl[o] = t;
        a.ap_f[5 * os + o] = ms * ms / una / 2.0f + ms * a.dt * 2.0f;
        a.ap_ce[o] = !ete || (etd > etl + len) || (ets >= 2.0f);
      }
    }
  }
}

}  // namespace

extern "C" int ring_pack(const RingPackArgs* args, int mode, void* stream) {
  const RingPackArgs a = *args;
  const int threads = 128;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.B == 0) return 0;
  if (a.lc && mode == 0 && (!a.l_gap || !a.l_yv)) return -1;
  if (a.tpl && ((mode == 0 && !a.l_tpl) || (mode == 2 && !a.k_tpl)))
    return -1;
  if (mode == 0) {
    if (a.IL * a.G == 0) return 0;
    forward_kernel<<<rr::grid_for(a.IL * a.G * a.B, threads), threads, 0,
                     st>>>(a);
  } else if (mode == 1) {
    if (a.LKp == 0) return 0;
    if (a.lc ? (!a.new_dis_l || !a.new_spd_l) : (!a.ap_dis || !a.ap_spd))
      return -1;
    entrant_kernel<<<rr::grid_for(a.LKp * a.B, threads), threads, 0, st>>>(
        a);
  } else if (mode == 2) {
    if (a.OLG == 0 || a.XKe == 0) return 0;
    if (a.lc && !a.k_gap) return -1;
    candidate_kernel<<<rr::grid_for(a.OLG * a.B, threads), threads, 0, st>>>(
        a);
  } else if (mode == 3) {
    if (a.LKp == 0 || a.AP == 0) return 0;
    if (a.tpl && (!a.et || !a.table || !a.ap_tpl || !a.ap_ce || a.TP < 1))
      return -1;
    approach_kernel<<<rr::grid_for(a.LKp * a.B, threads), threads, 0, st>>>(
        a);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
