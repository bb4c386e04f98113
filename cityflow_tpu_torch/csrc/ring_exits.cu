// R2 ring_exits: front departures, removals, the lane-change pair flags,
// blockers and lights of the ring step's commit.
//
// Replaces cityflow_tpu/core/ring.py :1462-1566 (crossings, the XK-slot
// leave prefixes, removals and their statistics, the pair bookkeeping
// around two partner exchanges) and :1908-1929 (the blocker commit and
// TrafficLight::passTime). There each is a chain of whole-ring where /
// and / sum passes over (SL, LNp) and (SK, LKp): the crossing prefix XK
// passes, the blocker SK + AP where-passes, the lights k_phase passes,
// each over the full array. Here one thread owns one lane column, link
// column or intersection of one env and walks its slots once:
//
//   mode 0 (exits)   lanes: the invalid clamp, the leave prefix, x_l, the
//                    removed / exited rows, OV_HOPS, the removed count and
//                    travel-time sum per lane, under lane change chanA /
//                    chanB; links: the leave prefix, x_k, OV_HOPS, the
//                    committed blocker; intersections: the lights. A
//                    second launch sums the per-lane partials per env.
//   mode 1 (pairs)   lane change, after partner round 1: abort_sh, the
//                    lateral offset, finish_pre.
//   mode 2 (finish)  lane change, after partner round 2: finish, die_mid,
//                    promote, the unlinks, the aborted shadows' count and
//                    time added per env (second launch).
//
// The per-env sums take each lane's slots in order, then the lanes
// through a fixed tree in one block per env: the same result every run,
// not torch.sum's order (t_rm within 1e-6 relative of the plain version;
// counts exact).
//
// Bound: bytes. Each lane ring channel it reads or writes once (new
// distances, n_l, nxt, last, enter; with lane change sh, chg, dir, off,
// speed and the partner channels), the link rings' new distances and
// blocker inputs once.
#include "ring_regions.cuh"

struct RingExitsArgs {
  // state and mid
  const float* new_dis_l;   // (SL, LNp, B)
  const int* n_l;           // (LNp, B)
  const int* l_nxt;
  const uint8_t *l_last, *l_sh, *l_chg;
  const int* l_dir;
  const float *l_off, *l_enter;
  const int* step;          // (B,)
  const float* nd_k;        // (SK, LKp, B)
  const int* n_k;           // (LKp, B)
  const uint8_t* k_fail;    // (SK, LKp, B)
  const int* k_fffoe;
  const uint8_t *ap_fail, *ap_red;  // (AP, LKp, B)
  const int* ap_ffo;
  const int* phase;         // (I, B)
  const float* remain;
  const float* new_spd_l;   // (SL, LNp, B)
  // tables
  const float *ln_len, *lk_len, *ln_maxoff_out, *ln_maxoff_in;
  const int* i_n_phases;
  const uint8_t* i_virtual;
  const int* i_phase_offset;
  const float* phase_time;
  // pair-stage inputs
  const uint8_t* leave_in;  // (SL, LNp, B)
  const float* pA;
  const uint8_t* pf;        // L4's found mask, both pair stages
  const float *abort_in, *finish_in, *pAb, *pFin;
  const float* pB;
  const int* n_rm_in;       // (B,)
  const float* t_rm_in;
  // outputs
  float* dis_l;             // (SL, LNp, B)
  uint8_t* leave;           // (SL or XKl, LNp, B)
  int* x_l;                 // (LNp, B)
  uint8_t* exited;          // (XKl, LNp, B)
  float *chanA, *chanB;     // (SL, LNp, B)
  uint8_t* leave_k;         // (XKe, LKp, B)
  int* x_k;                 // (LKp, B)
  int* blk;
  int* phase_out;           // (I, B)
  float* remain_out;
  float *abort_sh, *finish_pre, *new_off;   // (SL, LNp, B)
  uint8_t *die_mid, *promote, *unlink_real, *unlink_sh;
  int* n_rm;                // (B,)
  float* t_rm;
  int* ov;                  // (B,) OV_HOPS bits
  int* npart;               // (LNp, B) scratch
  float* tpart;
  long long SL, LNp, SK, LKp, B, I, AP, XKl, XKe, PT, k_phase, lc, lights;
  float dt;
};

#define OV_HOPS 4

template <bool LC>
__device__ void exits_lane(const RingExitsArgs& a, long long t) {
  const long long b = t % a.B;
  const long long p = t / a.B;
  const long long slab = a.LNp * a.B;
  const int n = a.n_l[t];
  const float len = a.ln_len[p];
  const float now = (float)a.step[b] * a.dt;
  bool pref = true, deep = false;
  int x = 0, nrm = 0;
  float trm = 0.0f;
  for (long long s = 0; s < a.SL; ++s) {
    const long long r = s * slab + t;
    const bool occ = s < n;
    float v = a.new_dis_l[r];
    bool last = false, shv = false;
    if (occ) {
      last = a.l_last[r] != 0;
      if (LC) shv = a.l_sh[r] != 0;
      if (a.l_nxt[r] < 0 && !last) v = tmin(v, len);
    }
    a.dis_l[r] = v;
    const bool cross = occ && v > len;
    bool lv = false;
    if (s < a.XKl) {
      pref = pref && cross;
      lv = pref;
      x += lv;
      a.leave[r] = lv;
      const bool removed = lv && (last || shv);
      a.exited[r] = lv && !last && !shv && a.l_nxt[r] >= 0;
      if (removed) {
        ++nrm;
        trm += now - a.l_enter[r];
      }
    } else {
      deep = deep || cross;
      if (LC) a.leave[r] = 0;
    }
    if (LC) {
      a.chanA[r] = (lv && !last) ? 1.0f : 0.0f;
      a.chanB[r] = (lv && last) ? 1.0f : 0.0f;
    }
  }
  a.x_l[t] = x;
  a.npart[t] = nrm;
  a.tpart[t] = trm;
  if (deep) atomicOr(&a.ov[b], OV_HOPS);
}

__device__ void exits_link(const RingExitsArgs& a, long long t) {
  const long long b = t % a.B;
  const long long lk = t / a.B;
  const long long slab = a.LKp * a.B;
  const int n = a.n_k[t];
  const float len = a.lk_len[lk];
  bool pref = true, deep = false;
  int x = 0;
  for (long long s = 0; s < a.SK; ++s) {
    const long long r = s * slab + t;
    const bool cross = s < n && a.nd_k[r] > len;
    if (s < a.XKe) {
      pref = pref && cross;
      x += pref;
      a.leave_k[r] = pref;
    } else {
      deep = deep || cross;
    }
  }
  a.x_k[t] = x;
  if (deep) atomicOr(&a.ov[b], OV_HOPS);
  // the front-most occupied failing slot's foe, else the front-most
  // failing approach row's (the plain version's reversed where-chains)
  int v = -1;
  for (long long s = a.SK - 1; s >= 0; --s) {
    const long long r = s * slab + t;
    if (s < n && a.k_fail[r]) v = a.k_fffoe[r];
  }
  for (long long ap = a.AP - 1; ap >= 0; --ap) {
    const long long r = ap * slab + t;
    if (v < 0 && a.ap_fail[r] && !a.ap_red[r]) v = a.ap_ffo[r];
  }
  a.blk[t] = v;
}

__device__ void exits_light(const RingExitsArgs& a, long long t) {
  const long long i = t / a.B;
  int ph = a.phase[t];
  float rem = a.remain[t];
  const int nph = a.i_n_phases[i];
  const bool has = nph > 0 && !a.i_virtual[i];
  if (has) rem = rem - a.dt;
  const int m = nph > 1 ? nph : 1;
  const long long off = a.i_phase_offset[i];
  for (long long k = 0; k < a.k_phase; ++k) {
    const bool go = has && rem <= 0.0f;
    int nx = ph;
    if (go) {
      nx = (ph + 1) % m;                // torch's remainder: sign of m
      if (nx < 0) nx += m;
    }
    long long pi = off + nx;
    pi = pi < 0 ? 0 : (pi > a.PT - 1 ? a.PT - 1 : pi);
    if (go) rem = rem + a.phase_time[pi];
    ph = nx;
  }
  a.phase_out[t] = ph;
  a.remain_out[t] = rem;
}

template <bool LC>
__global__ void ring_exits_kernel(const RingExitsArgs a) {
  const long long nl = a.LNp * a.B, nk = a.LKp * a.B;
  const long long total = nl + nk + (a.lights ? a.I * a.B : 0);
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    if (t < nl)
      exits_lane<LC>(a, t);
    else if (t < nl + nk)
      exits_link(a, t - nl);
    else
      exits_light(a, t - nl - nk);
  }
}

__global__ void ring_pairs_kernel(const RingExitsArgs a) {
  const long long slab = a.LNp * a.B;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < slab; t += (long long)gridDim.x * blockDim.x) {
    const long long p = t / a.B;
    const int n = a.n_l[t];
    const float mo_out = a.ln_maxoff_out[p], mo_in = a.ln_maxoff_in[p];
    for (long long s = 0; s < a.SL; ++s) {
      const long long r = s * slab + t;
      const bool occ = s < n;
      const bool shv = a.l_sh[r] != 0, last = a.l_last[r] != 0;
      const bool lv = a.leave_in[r] != 0;
      const int dir = a.l_dir[r];
      const bool chanA = lv && !last;
      const bool abort =
          occ && shv && !last && (chanA || (a.pf[r] && a.pA[r] > 0.5f));
      const float max_off = dir > 0 ? mo_out : mo_in;
      const float off = tmin(
          fabsf(a.l_off[r] +
                tmax(0.2f * a.new_spd_l[r], 1.0f) * a.dt * (float)dir),
          max_off);
      const bool chg_real = occ && a.l_chg[r] && !shv;
      a.abort_sh[r] = abort ? 1.0f : 0.0f;
      a.finish_pre[r] = (chg_real && off >= max_off && !lv) ? 1.0f : 0.0f;
      a.new_off[r] = off;
    }
  }
}

__global__ void ring_finish_kernel(const RingExitsArgs a) {
  const long long slab = a.LNp * a.B;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < slab; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t % a.B;
    const int n = a.n_l[t];
    const float now = (float)a.step[b] * a.dt;
    int ncm = 0;
    float tcm = 0.0f;
    for (long long s = 0; s < a.SL; ++s) {
      const long long r = s * slab + t;
      const bool occ = s < n;
      const bool shv = a.l_sh[r] != 0, lv = a.leave_in[r] != 0;
      const bool abort = a.abort_in[r] > 0.5f;
      const bool pAb = a.pAb[r] > 0.5f, pFin = a.pFin[r] > 0.5f;
      const bool pB = a.pB[r] > 0.5f;
      const bool pf = a.pf[r] != 0;
      const bool finish = a.finish_in[r] > 0.5f && !(pf && pAb);
      const bool cm = abort && !lv;
      const bool chg_real = occ && a.l_chg[r] && !shv;
      a.die_mid[r] = finish || cm;
      a.promote[r] = occ && shv && !abort && pf && pFin;
      a.unlink_real[r] = chg_real && (!pf || pAb || pB);
      a.unlink_sh[r] = occ && shv && (!pf || pB);
      if (cm) {
        ++ncm;
        tcm += now - a.l_enter[r];
      }
    }
    a.npart[t] = ncm;
    a.tpart[t] = tcm;
  }
}

// per env: the lanes' partials in a fixed order (strided per thread, then
// a tree over the block), plus the base values when given
#define RED_THREADS 256
__global__ void ring_env_sums_kernel(const RingExitsArgs a) {
  __shared__ int sn[RED_THREADS];
  __shared__ float st[RED_THREADS];
  const long long b = blockIdx.x;
  int n = 0;
  float tsum = 0.0f;
  for (long long p = threadIdx.x; p < a.LNp; p += RED_THREADS) {
    n += a.npart[p * a.B + b];
    tsum += a.tpart[p * a.B + b];
  }
  sn[threadIdx.x] = n;
  st[threadIdx.x] = tsum;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) {
      sn[threadIdx.x] += sn[threadIdx.x + w];
      st[threadIdx.x] += st[threadIdx.x + w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.n_rm[b] = (a.n_rm_in ? a.n_rm_in[b] : 0) + sn[0];
    a.t_rm[b] = a.t_rm_in ? a.t_rm_in[b] + st[0] : st[0];
  }
}

extern "C" int ring_exits(const RingExitsArgs* args, int mode, void* stream) {
  const RingExitsArgs a = *args;
  if (a.B == 0) return 0;
  if (a.XKl < 1 || a.XKe < 1 || a.XKl > a.SL || a.XKe > a.SK) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const long long nlane = a.LNp * a.B;
  if (mode == 0) {
    const long long total =
        nlane + a.LKp * a.B + (a.lights ? a.I * a.B : 0);
    if (a.lc)
      ring_exits_kernel<true><<<rr::grid_for(total, threads), threads, 0, s>>>(
          a);
    else
      ring_exits_kernel<false><<<rr::grid_for(total, threads), threads, 0,
                                 s>>>(a);
  } else if (mode == 1) {
    ring_pairs_kernel<<<rr::grid_for(nlane, threads), threads, 0, s>>>(a);
    return (int)cudaGetLastError();
  } else if (mode == 2) {
    ring_finish_kernel<<<rr::grid_for(nlane, threads), threads, 0, s>>>(a);
  } else {
    return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ring_env_sums_kernel<<<(unsigned)a.B, RED_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
