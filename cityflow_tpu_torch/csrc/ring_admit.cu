// R3 ring_admit: spawn and admission on the ring layout (Flow::nextStep +
// Engine::handleWaiting, engine.cpp:502-516), written in place.
//
// Replaces the spawn + admission region of cityflow_tpu/core/ring.py
// (:489-643). There every entry lane's values are spread to the lane axis
// by a one-hot (LNp, EL) einsum and each of about 16 lane leaves (25 with
// lane change) is rewritten whole through where(place, ...) over
// (SL, LNp): the TPU has no cheap scatter, and JAX's step is functional.
// The JAX batched entries donate their state, so here one thread owns one
// (entry lane, env): it reads its queue row at el_cursor, decides the
// admission (the row is due; Lane::available, roadnet.cpp:428-436; the slot
// exists, else OV_SLOTS), looks up the route's first hops and, under lane
// change, the route-row bundles and the admission-time gap, and writes
// every leaf of the one slot n_l of its lane. A second launch bumps n_l,
// so that no thread reads a lane count another has already moved (a lane
// change admission reads the first link's end lane's count).
//
// Bound: bytes. The queue rows, the entry lanes' counts and tails, and the
// admitted slots' leaves: about EL * B entries (10 MB at 30x30, B=128),
// where the where-chains moved every slot of every lane leaf.
#include "ring_regions.cuh"

struct RingAdmitArgs {
  const int *q_step, *q_flow, *q_pri, *q_route, *q_uid, *q_tpl;  // (EL, QCAP)
  const int* step;                     // (B,)
  const int *el_lane, *ln_llocal, *route_next, *route_aux, *route_len,
      *lk_end_lane;
  const float *ln_len, *lk_len, *table;
  const uint8_t* best_ex;              // (LNp, B), lane change
  const float* best_val;
  int* n_l;                            // (LNp, B)
  int* el_cursor;                      // (EL, B)
  float* l_dis;                        // (SL, LNp, B) ...
  float* l_speed;
  int *l_flow, *l_route, *l_rpos, *l_nxt, *l_nxt3, *l_prev;
  float* l_enter;
  int *l_pri, *l_uid;
  uint8_t* l_last;
  float* l_custom;
  uint8_t* l_hascustom;
  float* l_off;                        // lane change, else null ...
  uint8_t *l_sh, *l_chg;
  int* l_dir;
  float *l_gap, *l_yv;
  int *l_rnrow, *l_auxrow;             // (MAXLPR, SL, LNp, B)
  int* l_tpl;                          // templates, else null
  uint8_t* adm;                        // (EL, B) scratch: admitted
  int* ov;                             // (B,) OV_SLOTS bits
  long long EL, QCAP, SL, LNp, LKp, B, NR, RLEN, MAXLPR, TP;
  float p_speed0, p_len, p_avail, approach, dt;
};

#define OV_SLOTS 1

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <bool LC, bool TPL>
__global__ void ring_admit_kernel(const RingAdmitArgs a) {
  const long long total = a.EL * a.B;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t % a.B;
    const long long e = t / a.B;
    const int cursor = a.el_cursor[t];
    const long long qi = e * a.QCAP + clampll(cursor, 0, a.QCAP - 1);
    const int r_step = a.q_step[qi];
    const bool has_row = cursor < a.QCAP && r_step >= 0 && r_step <= a.step[b];
    const long long lane = a.el_lane[e];
    const int n_e = a.n_l[lane * a.B + b];
    const long long tail = ((n_e > 1 ? n_e - 1 : 0) * a.LNp + lane) * a.B + b;
    const float t_dis = a.l_dis[tail];
    float t_len = a.p_len, q_speed = a.p_speed0, q_maxspd = 0.0f,
          q_una = 0.0f;
    int q_tpl = 0;
    bool avail;
    if (TPL) {
      q_tpl = a.q_tpl[qi];
      t_len = rr::tparam(a.table, a.TP, a.l_tpl[tail], rr::P_LEN);
      q_speed = rr::tparam(a.table, a.TP, q_tpl, rr::P_SPEED);
      const float q_mingap = rr::tparam(a.table, a.TP, q_tpl, rr::P_MINGAP);
      q_maxspd = rr::tparam(a.table, a.TP, q_tpl, rr::P_MAXSPEED);
      q_una = rr::tparam(a.table, a.TP, q_tpl, rr::P_USUALNEGACC);
      avail = n_e == 0 || t_dis > t_len + q_mingap;
    } else {
      avail = n_e == 0 || t_dis > a.p_avail;
    }
    const bool admit = has_row && avail && n_e < a.SL;
    if (has_row && avail && n_e >= a.SL) atomicOr(&a.ov[b], OV_SLOTS);
    a.adm[t] = admit;
    if (!admit) continue;
    a.el_cursor[t] = cursor + 1;

    // the route's first hops (the rn_at lookups of the plain version)
    const long long route = clampll(a.q_route[qi], 0, a.NR - 1);
    auto rn_at = [&](long long pos, long long llocal) {
      return a.route_next[(route * a.RLEN + clampll(pos, 0, a.RLEN - 1)) *
                              a.MAXLPR +
                          clampll(llocal, 0, a.MAXLPR - 1)];
    };
    const int nxt0 = rn_at(0, a.ln_llocal[lane]);
    const long long lkx = clampll((long long)nxt0 - a.LNp, 0, a.LKp - 1);
    const int end0 = a.lk_end_lane[lkx];
    // jnp.take of ln_llocal at max(end0, 0): INT_MIN past the end
    const long long e0 = end0 > 0 ? end0 : 0;
    const long long ll = e0 < a.LNp ? (long long)a.ln_llocal[e0]
                                    : (long long)(-2147483647 - 1);
    const int nxt3 = nxt0 >= 0 ? rn_at(1, ll) : -1;
    const bool last = a.route_len[route] <= 1;

    const long long o = ((long long)n_e * a.LNp + lane) * a.B + b;
    const long long slab = a.SL * a.LNp * a.B;
    a.l_dis[o] = 0.0f;
    a.l_speed[o] = q_speed;
    a.l_flow[o] = rr::via_f32(a.q_flow[qi]);
    a.l_route[o] = rr::via_f32((int)route);
    a.l_rpos[o] = 0;
    a.l_nxt[o] = rr::via_f32(nxt0);
    a.l_nxt3[o] = rr::via_f32(nxt3);
    a.l_prev[o] = -1;
    a.l_enter[o] = (float)r_step * a.dt;
    const int pri = a.q_pri[qi];
    a.l_pri[o] = (int)((unsigned)xla_f32_to_i32(rr::pri_hi(pri)) << 16) |
                 xla_f32_to_i32(rr::pri_lo(pri));
    a.l_uid[o] = rr::via_f32(a.q_uid[qi]);
    a.l_last[o] = last;
    a.l_custom[o] = 0.0f;
    a.l_hascustom[o] = 0;
    if (LC) {
      const long long base = route * a.RLEN * a.MAXLPR;
      for (long long c = 0; c < a.MAXLPR; ++c) {
        a.l_rnrow[c * slab + o] = rr::via_f32(a.route_next[base + c]);
        a.l_auxrow[c * slab + o] = rr::via_f32(a.route_aux[base + c]);
      }
      // the admission-time gap: the pre-push tail, else the scan past the
      // lane's end (out-link ring tails, then the first link's end-lane
      // tail within the lookahead bound)
      const float ln_len_e = a.ln_len[lane];
      const float nlen = a.lk_len[lkx];
      const long long end_c = clampll(end0, 0, a.LNp - 1);
      const int n_end = a.n_l[end_c * a.B + b];
      const long long et =
          ((n_end > 1 ? n_end - 1 : 0) * a.LNp + end_c) * a.B + b;
      const float etd = a.l_dis[et];
      const float etl =
          TPL ? rr::tparam(a.table, a.TP, a.l_tpl[et], rr::P_LEN) : a.p_len;
      const float approach =
          TPL ? q_maxspd * q_maxspd / q_una / 2.0f + q_maxspd * a.dt * 2.0f
              : a.approach;
      const bool b_ex = a.best_ex[lane * a.B + b] != 0;
      const bool f1 = nxt0 >= 0 && b_ex;
      const bool f2 = nxt0 >= 0 && !b_ex && n_end > 0 &&
                      ln_len_e + nlen <= approach;
      const float scan =
          f1 ? ln_len_e + a.best_val[lane * a.B + b]
             : (f2 ? ln_len_e + nlen + etd - etl : 0.0f);
      a.l_gap[o] = n_e > 0 ? t_dis - t_len : scan;
      a.l_off[o] = 0.0f;
      a.l_sh[o] = 0;
      a.l_chg[o] = 0;
      a.l_dir[o] = 0;
      a.l_yv[o] = 100.0f;
    }
    if (TPL) a.l_tpl[o] = rr::via_f32(q_tpl);
  }
}

// the lane counts, after every thread has read the ones it needs
__global__ void ring_admit_count_kernel(const RingAdmitArgs a) {
  const long long total = a.EL * a.B;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    if (a.adm[t]) a.n_l[a.el_lane[t / a.B] * a.B + t % a.B] += 1;
  }
}

extern "C" int ring_admit(const RingAdmitArgs* args, void* stream) {
  const RingAdmitArgs a = *args;
  const long long total = a.EL * a.B;
  if (total == 0) return 0;
  if (a.QCAP < 1 || a.NR < 1 || a.RLEN < 1 || a.MAXLPR < 1) return -1;
  const int threads = 128;
  const unsigned grid = rr::grid_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const bool lc = a.l_off != nullptr, tpl = a.l_tpl != nullptr;
  if (lc && tpl)
    ring_admit_kernel<true, true><<<grid, threads, 0, s>>>(a);
  else if (lc)
    ring_admit_kernel<true, false><<<grid, threads, 0, s>>>(a);
  else if (tpl)
    ring_admit_kernel<false, true><<<grid, threads, 0, s>>>(a);
  else
    ring_admit_kernel<false, false><<<grid, threads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ring_admit_count_kernel<<<grid, threads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
