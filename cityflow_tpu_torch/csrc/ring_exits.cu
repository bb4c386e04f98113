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
//   mode 0 (exits)   lanes: the invalid clamp (in place on the new
//                    distances), the leave prefix, x_l, the removed /
//                    exited rows, OV_HOPS, the removed count and
//                    travel-time sum, under lane change chanA / chanB;
//                    links: the leave prefix, x_k, OV_HOPS, the committed
//                    blocker; intersections: the lights. Lanes, links and
//                    lights take blocks of their own; a lane or link block
//                    reduces its partials per env, and a second launch
//                    sums the blocks' partials per env.
//   mode 1 (pairs)   lane change, after partner round 1: abort_sh, the
//                    lateral offset, finish_pre.
//   mode 2 (finish)  lane change, after partner round 2: finish, die_mid,
//                    promote, the unlinks, the aborted shadows' count and
//                    time added per env (second launch).
//
// The per-env sums are in a fixed order, the same result every run, not
// torch.sum's (t_rm within 1e-6 relative of the plain version; counts
// exact). Mode 0: each lane's slots in order; a thread's lpt lanes in
// order; the LY threads of a (block, env) in a tree; then row y of the
// second launch takes the blocks y, y + SUM_Y, ... in order, and a tree
// over its SUM_Y = 32 rows. Mode 2: each lane's slots in order, then the
// lanes strided over a block per env and a tree.
//
// Bound: bytes, as the call's data reads them. Mode 0: n_l and n_k, the
// occupied slots' new distances (link rings too), last and nxt past a
// lane's end, the removed vehicles' enter times, the link blockers up to
// the front-most failure, the lights, and the outputs (the clamp only
// where it applies). Modes 1 and 2: each lane ring channel once.
#include "ring_regions.cuh"

struct RingExitsArgs {
  // state and mid
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
  float* dis_l;             // (SL, LNp, B) the new distances: mode 0
                            // reads them and clamps them in place
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
  int* npart;               // scratch: (LNp, B) mode 2, (nlg, B) mode 0
  float* tpart;
  int* dpart;               // (nlg + nkg, B) mode 0
  long long SL, LNp, SK, LKp, B, I, AP, XKl, XKe, PT, k_phase, lc, lights;
  long long off_lim;        // mode 0: 32-bit offsets below it (see below)
  float dt;
};

#define OV_HOPS 4

// ---- mode 0 ----------------------------------------------------------------
// A block takes one kind: a group of lpt * LY lanes (kpt * LY links) by TB
// envs (TB = 32 from B = 32 on, else B rounded up to a power of two; LY =
// EX_THREADS / TB), a thread lpt lanes (kpt links) of one env in turn,
// envs across the warp; or EX_THREADS (intersection, env) lights. lpt =
// EX_LPT and kpt = EX_KPT from B = 32 on (fewer partials to sum), else 1
// (at one env a block of 256 lanes, not EX_LPT times that). Offsets are
// 32-bit (IX = int) where every ring, table and partial holds fewer
// elements than off_lim (at most 2^31 - 1), else 64-bit (32-bit ones are
// faster on an H100: PERF.md section 7).
#define EX_THREADS 256
#define EX_LPT 8     // lanes a thread takes in turn (B >= 32)
#define EX_KPT 8     // links a thread takes in turn (B >= 32)
#define EX_U 4       // slots whose loads are issued before any is used
#define EX_MINB 4    // resident blocks an SM (at most 64 registers)
#define EX_AP 4      // approach rows whose flags are loaded together

struct ExGeom {
  int TB, LY, tiles, lpt, kpt;
  long long nlg, nkg;            // lane groups, link groups
  long long lane_blocks, link_blocks;
};

__host__ __forceinline__ ExGeom ex_geom(const RingExitsArgs& a) {
  ExGeom g;
  g.TB = 32;
  if (a.B < 32) {
    g.TB = 1;
    while (g.TB < a.B) g.TB <<= 1;
  }
  g.LY = EX_THREADS / g.TB;
  g.tiles = (int)((a.B + g.TB - 1) / g.TB);
  g.lpt = a.B >= 32 ? EX_LPT : 1;
  g.kpt = a.B >= 32 ? EX_KPT : 1;
  const long long pl = (long long)g.LY * g.lpt, pk = (long long)g.LY * g.kpt;
  g.nlg = (a.LNp + pl - 1) / pl;
  g.nkg = (a.LKp + pk - 1) / pk;
  g.lane_blocks = g.nlg * g.tiles;
  g.link_blocks = g.nkg * g.tiles;
  return g;
}

// One lane column (p, b), front first. The first EX_U slots' new
// distances are loaded with n_l (before it is known which are occupied),
// the later ones only up to n_l; last and nxt only where the distance is
// past the lane's end (or the length is NaN), where the clamp can change
// it or it crosses: elsewhere min(v, len) is v bit for bit and nothing
// crosses. The clamp is written in place, only where it applies.
template <bool LC, typename IX>
__device__ __forceinline__ void exits_lane(const RingExitsArgs& a, IX p,
                                           IX b, int& nrm, float& trm,
                                           bool& deep) {
  const IX slab = (IX)a.LNp * (IX)a.B;
  const IX t = p * (IX)a.B + b;
  float* dis = a.dis_l;
  float v[EX_U];
#pragma unroll
  for (int u = 0; u < EX_U; ++u)
    v[u] = u < a.SL ? dis[(IX)u * slab + t] : 0.0f;
  const int n = a.n_l[t];
  const int m = n < 0 ? 0 : (n > a.SL ? (int)a.SL : n);
  const float len = a.ln_len[p];
  const float now = (float)a.step[b] * a.dt;
  const int XK = (int)a.XKl;
  const int S = m > XK ? m : XK;
  bool pref = true;
  int x = 0;
  for (int s0 = 0; s0 < S; s0 += EX_U) {
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < EX_U; ++u)
        v[u] = s0 + u < m ? dis[(IX)(s0 + u) * slab + t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < EX_U; ++u) {
      const int s = s0 + u;
      if (s >= S) break;
      const IX r = (IX)s * slab + t;
      bool cross = false, last = false;
      int nxt = -1;
      float vv = v[u];
      if (s < m && vv == vv && !(vv <= len)) {
        last = a.l_last[r] != 0;
        if (!last) {
          nxt = a.l_nxt[r];
          if (nxt < 0) {                 // invalid: never crosses
            vv = tmin(vv, len);
            dis[r] = vv;
          }
        }
        cross = vv > len;
      }
      if (s < XK) {
        pref = pref && cross;
        const bool lv = pref;
        x += lv;
        a.leave[r] = lv;
        const bool shv = LC && lv && a.l_sh[r] != 0;
        a.exited[r] = lv && !last && !shv && nxt >= 0;
        if (lv && (last || shv)) {       // removed
          ++nrm;
          trm += now - a.l_enter[r];
        }
        if (LC) {
          a.chanA[r] = (lv && !last) ? 1.0f : 0.0f;
          a.chanB[r] = (lv && last) ? 1.0f : 0.0f;
        }
      } else {
        deep = deep || cross;
      }
    }
  }
  if (LC) {
    for (int s = XK; s < a.SL; ++s) {
      const IX r = (IX)s * slab + t;
      a.leave[r] = 0;
      a.chanA[r] = 0.0f;
      a.chanB[r] = 0.0f;
    }
  }
  a.x_l[t] = x;
}

// One link column: the leave prefix, then the committed blocker: the
// front-most occupied failing slot's foe, else, walking the approach rows
// as the plain version's where-chain does (AP - 1 down to 0, a row taken
// while the blocker is still negative), the failing non-red rows' foe.
// The first EX_U slots' distances and k_fail and the last EX_AP approach
// rows' ap_fail and ap_red are loaded with n_k (most links are empty: the
// blocker then needs one more load, the taken row's foe); later slots only
// up to n_k, k_fail only until a failing slot is met, the foes only where
// taken.
template <typename IX>
__device__ __forceinline__ void exits_link(const RingExitsArgs& a, IX lk,
                                           IX b, bool& deep) {
  const IX slab = (IX)a.LKp * (IX)a.B;
  const IX t = lk * (IX)a.B + b;
  float v[EX_U];
  uint8_t f[EX_U], af[EX_AP], ar[EX_AP];
#pragma unroll
  for (int u = 0; u < EX_U; ++u) {
    const bool in = u < a.SK;
    v[u] = in ? a.nd_k[(IX)u * slab + t] : 0.0f;
    f[u] = in ? a.k_fail[(IX)u * slab + t] : 0;
  }
#pragma unroll
  for (int u = 0; u < EX_AP; ++u) {
    const int ap = (int)a.AP - 1 - u;
    af[u] = ap >= 0 ? a.ap_fail[(IX)ap * slab + t] : 0;
    ar[u] = ap >= 0 ? a.ap_red[(IX)ap * slab + t] : 1;
  }
  const int n = a.n_k[t];
  const int m = n < 0 ? 0 : (n > a.SK ? (int)a.SK : n);
  const float len = a.lk_len[lk];
  const int XK = (int)a.XKe;
  const int S = m > XK ? m : XK;
  bool pref = true;
  int x = 0, first = -1;
  for (int s0 = 0; s0 < S; s0 += EX_U) {
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < EX_U; ++u) {
        const bool occ = s0 + u < m;
        const IX r = (IX)(s0 + u) * slab + t;
        v[u] = occ ? a.nd_k[r] : 0.0f;
        f[u] = (occ && first < 0) ? a.k_fail[r] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < EX_U; ++u) {
      const int s = s0 + u;
      if (s >= S) break;
      const bool occ = s < m;
      const bool cross = occ && v[u] > len;
      if (s < XK) {
        pref = pref && cross;
        x += pref;
        a.leave_k[(IX)s * slab + t] = pref;
      } else {
        deep = deep || cross;
      }
      if (first < 0 && occ && f[u]) first = s;
    }
  }
  a.x_k[t] = x;
  int blk = first >= 0 ? a.k_fffoe[(IX)first * slab + t] : -1;
  for (int a0 = (int)a.AP - 1; a0 >= 0 && blk < 0; a0 -= EX_AP) {
    if (a0 != (int)a.AP - 1) {
#pragma unroll
      for (int u = 0; u < EX_AP; ++u) {
        af[u] = a0 - u >= 0 ? a.ap_fail[(IX)(a0 - u) * slab + t] : 0;
        ar[u] = af[u] ? a.ap_red[(IX)(a0 - u) * slab + t] : 1;
      }
    }
#pragma unroll
    for (int u = 0; u < EX_AP; ++u)
      if (blk < 0 && af[u] && !ar[u])
        blk = a.ap_ffo[(IX)(a0 - u) * slab + t];
  }
  a.blk[t] = blk;
}

template <typename IX>
__device__ __forceinline__ void exits_light(const RingExitsArgs& a, IX t) {
  const IX i = t / (IX)a.B;
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

// The first launch: lane blocks, then link blocks, then light blocks. A
// lane or link block reduces its threads' removed counts, travel-time
// sums and OV_HOPS flags per env over threadIdx.y in a fixed tree and
// writes one partial per (group, env): npart / tpart / dpart rows [0,
// nlg) for the lane groups, dpart rows [nlg, nlg + nkg) for the links.
template <bool LC, typename IX>
__global__ void __launch_bounds__(EX_THREADS, EX_MINB)
    ring_exits_kernel(const RingExitsArgs a, const ExGeom g) {
  __shared__ int sn[EX_THREADS], sd[EX_THREADS];
  __shared__ float st[EX_THREADS];
  long long blk = blockIdx.x;
  if (blk >= g.lane_blocks + g.link_blocks) {
    const long long t =
        (blk - g.lane_blocks - g.link_blocks) * EX_THREADS + threadIdx.x;
    if (t < a.I * a.B) exits_light<IX>(a, (IX)t);
    return;
  }
  const bool lanes = blk < g.lane_blocks;
  if (!lanes) blk -= g.lane_blocks;
  const long long grp = blk / g.tiles;
  const int tx = threadIdx.x % g.TB, ty = threadIdx.x / g.TB;
  const long long b = (blk % g.tiles) * g.TB + tx;
  int nrm = 0;
  float trm = 0.0f;
  bool deep = false;
  if (b < a.B) {
    if (lanes) {
      const long long c0 = grp * g.LY * g.lpt + ty;
#pragma unroll 1
      for (int k = 0; k < g.lpt; ++k) {
        const long long c = c0 + (long long)k * g.LY;
        if (c < a.LNp) exits_lane<LC, IX>(a, (IX)c, (IX)b, nrm, trm, deep);
      }
    } else {
      const long long c0 = grp * g.LY * g.kpt + ty;
#pragma unroll 1
      for (int k = 0; k < g.kpt; ++k) {
        const long long c = c0 + (long long)k * g.LY;
        if (c < a.LKp) exits_link<IX>(a, (IX)c, (IX)b, deep);
      }
    }
  }
  sn[threadIdx.x] = nrm;
  st[threadIdx.x] = trm;
  sd[threadIdx.x] = deep;
  __syncthreads();
  for (int h = g.LY / 2; h > 0; h >>= 1) {
    if (ty < h) {
      const int o = threadIdx.x + h * g.TB;
      sn[threadIdx.x] += sn[o];
      st[threadIdx.x] += st[o];
      sd[threadIdx.x] |= sd[o];
    }
    __syncthreads();
  }
  if (ty == 0 && b < a.B) {
    const long long row = lanes ? grp : g.nlg + grp;
    a.dpart[row * a.B + b] = sd[threadIdx.x];
    if (lanes) {
      a.npart[grp * a.B + b] = sn[threadIdx.x];
      a.tpart[grp * a.B + b] = st[threadIdx.x];
    }
  }
}

// The second launch: per env, the groups' partials in a fixed order (a
// block of 32 envs by SUM_Y rows; row y takes groups y, y + SUM_Y, ... in
// turn, then a tree over the rows): n_rm, t_rm, and ov (OV_HOPS where a
// lane or link of the env crossed past its first XK slots).
#define SUM_Y 32
__global__ void __launch_bounds__(32 * SUM_Y)
    exits_env_sums_kernel(const RingExitsArgs a, const ExGeom g) {
  __shared__ int sn[32 * SUM_Y], sd[32 * SUM_Y];
  __shared__ float st[32 * SUM_Y];
  const int tx = threadIdx.x % 32, y = threadIdx.x / 32;
  const long long b = (long long)blockIdx.x * 32 + tx;
  int n = 0, d = 0;
  float tsum = 0.0f;
  if (b < a.B) {
#pragma unroll 4
    for (long long r = y; r < g.nlg; r += SUM_Y) {
      n += a.npart[r * a.B + b];
      tsum += a.tpart[r * a.B + b];
      d |= a.dpart[r * a.B + b];
    }
#pragma unroll 4
    for (long long r = g.nlg + y; r < g.nlg + g.nkg; r += SUM_Y)
      d |= a.dpart[r * a.B + b];
  }
  sn[threadIdx.x] = n;
  st[threadIdx.x] = tsum;
  sd[threadIdx.x] = d;
  __syncthreads();
  for (int h = SUM_Y / 2; h > 0; h >>= 1) {
    if (y < h) {
      sn[threadIdx.x] += sn[threadIdx.x + 32 * h];
      st[threadIdx.x] += st[threadIdx.x + 32 * h];
      sd[threadIdx.x] |= sd[threadIdx.x + 32 * h];
    }
    __syncthreads();
  }
  if (y == 0 && b < a.B) {
    a.n_rm[b] = sn[tx];
    a.t_rm[b] = st[tx];
    a.ov[b] = sd[tx] ? OV_HOPS : 0;
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

// The exits stage's partial rows at B envs: lane groups, link groups
// (the wrapper allocates npart / tpart (nlg, B) and dpart (nlg + nkg, B)).
extern "C" int ring_exits_groups(long long B, long long LNp, long long LKp,
                                 long long* nlg, long long* nkg) {
  RingExitsArgs a = {};
  a.B = B;
  a.LNp = LNp;
  a.LKp = LKp;
  const ExGeom g = ex_geom(a);
  *nlg = g.nlg;
  *nkg = g.nkg;
  return 0;
}

extern "C" int ring_exits(const RingExitsArgs* args, int mode, void* stream) {
  const RingExitsArgs a = *args;
  if (a.B == 0) return 0;
  if (a.XKl < 1 || a.XKe < 1 || a.XKl > a.SL || a.XKe > a.SK) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const long long nlane = a.LNp * a.B;
  if (mode == 0) {
    const ExGeom g = ex_geom(a);
    const long long light_blocks =
        a.lights ? (a.I * a.B + EX_THREADS - 1) / EX_THREADS : 0;
    const long long blocks = g.lane_blocks + g.link_blocks + light_blocks;
    if (blocks > 0x7FFFFFFFLL) return -1;
    // 32-bit offsets where every ring, table and partial fits
    const long long lim = a.off_lim < 0x7FFFFFFFLL ? a.off_lim : 0x7FFFFFFFLL;
    const bool fits = a.SL * a.LNp * a.B < lim && a.SK * a.LKp * a.B < lim &&
                      a.AP * a.LKp * a.B < lim && a.I * a.B < lim &&
                      (g.nlg + g.nkg) * a.B < lim;
    if (blocks > 0) {
      const unsigned nb = (unsigned)blocks;
      if (a.lc && fits)
        ring_exits_kernel<true, int><<<nb, EX_THREADS, 0, s>>>(a, g);
      else if (a.lc)
        ring_exits_kernel<true, long long><<<nb, EX_THREADS, 0, s>>>(a, g);
      else if (fits)
        ring_exits_kernel<false, int><<<nb, EX_THREADS, 0, s>>>(a, g);
      else
        ring_exits_kernel<false, long long><<<nb, EX_THREADS, 0, s>>>(a, g);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    exits_env_sums_kernel<<<(unsigned)((a.B + 31) / 32), 32 * SUM_Y, 0, s>>>(
        a, g);
    return (int)cudaGetLastError();
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
