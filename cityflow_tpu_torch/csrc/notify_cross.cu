// G3 notify_cross: Engine::threadNotifyCross (reference engine.cpp:317-372)
// for every (lanelink, cross slot): the notifier, i.e. the candidate with
// the largest front position whose tail has not cleared the cross, and the
// terms Cross::canPass reads about it (roadnet.cpp:604-660).
//
// Replaces notify_cross in cityflow_tpu/core/step.py (:467-594), which the
// TPU runs in (KC, LL) layout as a K2 = k_link + 2 round where-chain over
// G1's dense link tables of attribute packs, a one-hot einsum on the MXU
// to fetch the winner's 10 float channels, and a static permutation
// (lnk_cross_foe_pos) to the foe side. No permutation pass runs here: G4
// reads the foe side through lnk_cross_foe_pos. No pack or table is built
// either: the lanelink's vehicles are sorted_idx[drv_off[L + ll] + r], r <
// min(k_link, its count) (G1's order), and every candidate's attributes
// are read from the state's own leaves (dis, speed, six params columns,
// G9's cyc, prev_drv, enter_ll_time, priority).
//
// A group of NC_G = 8 threads owns one (lanelink, env); four groups share
// a warp, so a warp keeps four lanelinks' loads in flight (of 4, 8, 16
// and 32 threads a group, 8 was the fastest at one env and at B = 128 on
// the H100: PERF.md, Findings). The group first reads its
// candidates once, for all the link's crosses, with the terms the
// notifier's entries need and the parts of canYield and getReachSteps
// that do not depend on the cross: lanes 0 and 1 the end lane's rear
// vehicle and the start lane's front vehicle (a chain of three loads
// each, beside which the other lanes read the first rows), then the
// link's first min(k_link, count) vehicles, G a round. The end vehicle is
// kept in slot 0 whatever it is (its terms are the plain version's
// default, index 0, where a cross has no notifier), the start vehicle in
// slot 1, the link's vehicles in order after them. Then the warp's lanes
// take its groups' (cross, lanelink) cells, which lie contiguous in every
// output, a lane a cell, so that each store is a run of 32 (of 16 or 8
// where k_link is so large that the wrapper gives a block only 2 or 1
// groups): a cell keeps the first strict maximum over the candidates its
// distance admits in the plain version's order (the end vehicle where
// e_ok and tail < d, each link vehicle where tail <= d, the start vehicle
// where s_ok) and writes the ten own-side entries from shared memory,
// reach steps from the branch it selects only. e_ok compares prev_drv as
// the int32 it is (the JAX package compares it cast to its float type:
// the same below 2^24 drivables).
//
// B envs at once: the env is blockIdx.y; the env offsets of the per-env
// arrays are 32-bit, computed once per thread (the wrapper refuses B * V
// * NP, B * LL * KC and B * (D + 1) past 2^31); the net tables are
// shared. Inputs are read through __ldg.
//
// Bound: bytes. Per (lanelink, env) the two end slots, the end vehicle's
// prev and, where it names the link, its dis and len, the start vehicle's
// next drivable, ll_avail and, where they admit it, its dis; the link's
// two offsets, its vehicles' slots and their dis and len; per distinct
// winner its other terms; per (lanelink, cross) the cross distance
// (shared by the envs); the ten outputs.
#include "gen1.cuh"

using namespace gen1;

constexpr int NC_THREADS = 256;
constexpr int NC_LGG = 3, NC_G = 1 << NC_LGG;     // threads a group

struct NotifyArgs {
  const void* d;            // (LL, KC) T cross distance on the link
  const void* drv_len;      // (D,) T
  const int* ll_end;        // (LL,)
  const int* ll_start;      // (LL,)
  const uint8_t* ll_is_turn;  // (LL,)
  const int* last_of;       // (B, D)
  const int* first_of;      // (B, D)
  const int* sorted_idx;    // (B, V)
  const int* drv_off;       // (B, D + 1)
  const int* veh_next;      // (B, V)
  const uint8_t* ll_avail;  // (B, LL)
  const void* dis;          // (B, V) T
  const void* speed;        // (B, V) T
  const void* params;       // (B, V, NP) T
  const uint8_t* cyc;       // (B, V) G9's blocker-cycle flags
  const int* prev_drv;      // (B, V)
  const int* ent;           // (B, V) enter_ll_time
  const int* pri;           // (B, V) priority
  const void* interval;     // () T
  uint8_t* exists;          // (B, LL, KC) each
  uint8_t* yld;
  uint8_t* cleared;
  uint8_t* cyc_out;
  uint8_t* dpos;
  void* dist;               // T
  int* reach;
  int* ent_out;
  int* pri_out;
  int* idx;
  int B, LL, KC, K, NP, V, L, D, fp32;
};

// one env's slot leaves
template <typename T>
struct Leaves {
  const T *dis, *speed, *P;
  const uint8_t* cyc;
  const int *prev, *ent, *pri;
  int NP;
};

// a candidate: its slot, front position, the tail compared with the
// cross distance, the pack terms of the
// notifier's entries, and the parts of canYield and getReachSteps that do
// not depend on the cross (the brake distance, distance_until_speed, the
// first ceil of the accelerating branch), each computed as the plain
// version computes it
template <typename T>
struct Cand {
  T pk, tail, len, speed, yld, cyc, upa, target, min_brake, dts, rb1;
  int v, ent, pri;
};

template <typename T>
__device__ __forceinline__ void pack_terms(Cand<T>& c, const Leaves<T>& lv,
                                           int s, bool is_turn, T dt) {
  const T* p = lv.P + s * lv.NP;
  c.len = __ldg(p + P_LEN);
  c.speed = __ldg(lv.speed + s);
  const T maxneg = __ldg(p + P_MAXNEGACC);
  c.yld = __ldg(p + P_YIELD);
  c.cyc = __ldg(lv.cyc + s) ? T(1) : T(0);
  c.upa = __ldg(p + P_USUALPOSACC);
  c.target = __ldg(p + (is_turn ? P_TURNSPEED : P_MAXSPEED));
  c.ent = __ldg(lv.ent + s);
  c.pri = __ldg(lv.pri + s);
  c.min_brake = T(0.5) * c.speed * c.speed / maxneg;
  c.dts = distance_until_speed(c.speed, c.target, c.upa, dt);
  c.rb1 = ceil((c.target - c.speed) / c.upa / dt);
}

// reach_steps (gen1.cuh) at distance d, only the branch it selects
template <typename T>
__device__ __forceinline__ int reach_at(const Cand<T>& c, T d, T dt) {
  if (d <= T(0)) return 0;
  T r;
  if (c.speed > c.target)
    r = ceil(d / ((c.speed > T(0)) ? c.speed : T(1)));
  else if (c.dts > d)
    r = ceil((sqrt(tmax(c.speed * c.speed + T(2) * c.upa * d, T(0))) -
              c.speed) / c.upa / dt);
  else
    r = c.rb1 + ceil((d - c.dts) / c.target / dt);
  return xla_to_i32(r);
}

template <typename T>
__global__ void __launch_bounds__(NC_THREADS)
notify_cross_kernel(const NotifyArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int lgg = NC_LGG, G = NC_G;
  const int K = a.K, SLOTS = K + 2;         // a group's: the end vehicle,
                                            // the start vehicle, the link's
  const int gi = threadIdx.x & (G - 1);              // lane in the group
  const int grp = threadIdx.x >> lgg;                // group in the block
  const int lane = threadIdx.x & 31;
  const int groups = (int)(blockDim.x >> lgg);
  const int l = (int)blockIdx.x * groups + grp;
  const bool live = l < a.LL;
  const int b = (int)blockIdx.y;
  const int eD = b * a.D, eV = b * a.V, eLL = b * a.LL;
  const Leaves<T> lv{(const T*)a.dis + eV, (const T*)a.speed + eV,
                     (const T*)a.params + eV * a.NP, a.cyc + eV,
                     a.prev_drv + eV, a.ent + eV, a.pri + eV, a.NP};
  const T* drv_len = (const T*)a.drv_len;
  // per group: slot 0 the end vehicle (also the default terms), slot 1
  // the start vehicle, then the link's vehicles in order; after all
  // groups' slots, per group the link's count and the two flags
  Cand<T>* cands = reinterpret_cast<Cand<T>*>(smem_raw);
  Cand<T>* mine = cands + grp * SLOTS;
  int* info = reinterpret_cast<int*>(cands + groups * SLOTS);
  const int l_drv = a.L + l;
  const bool is_turn = live && __ldg(a.ll_is_turn + l) != 0;
  const T dt = __ldg((const T*)a.interval);
  // the link's vehicles: G1's order from its first position
  int off = 0, nk = 0;
  if (live) {
    const int* o = a.drv_off + b * (a.D + 1) + l_drv;
    off = __ldg(o);
    nk = min(__ldg(o + 1) - off, K);
  }
  // the two end vehicles, lanes 0 and 1, each a chain of three loads:
  // their own slot, so that the link vehicles' loads overlap them
  if (live && gi < 2) {
    Cand<T> c;
    const bool end = gi == 0;
    const int lane_of = __ldg((end ? a.ll_end : a.ll_start) + l);
    const int slot = __ldg((end ? a.last_of : a.first_of) + eD + lane_of);
    const int s = (int)clampll(slot, 0, a.V - 1);
    pack_terms(c, lv, s, is_turn, dt);
    const T dis = __ldg(lv.dis + s);
    c.v = slot;
    bool keep;
    if (end) {
      keep = slot >= 0 && __ldg(lv.prev + s) == l_drv;
      c.pk = __ldg(drv_len + l_drv) + dis;
      c.tail = c.pk - c.len;
    } else {
      keep = slot >= 0 && __ldg(a.veh_next + eV + s) == l_drv &&
             __ldg(a.ll_avail + eLL + l) != 0;
      c.pk = -(__ldg(drv_len + lane_of) - dis);
      c.tail = T(0);
    }
    mine[gi] = c;
    info[groups + 2 * grp + gi] = keep;
  }
  // the link's vehicles front to back, the first G - 2 beside the end
  // vehicles, then G a round
  for (int j0 = -2; j0 < nk; j0 += G) {
    const int j = j0 + gi;
    if (j >= 0 && j < nk) {
      Cand<T> c;
      c.v = __ldg(a.sorted_idx + eV + off + j);
      pack_terms(c, lv, c.v, is_turn, dt);
      c.pk = __ldg(lv.dis + c.v);
      c.tail = c.pk - c.len;
      mine[2 + j] = c;
    }
  }
  if (gi == 0 && live) info[grp] = nk;
  __syncwarp();
  // the cells of the warp's groups, contiguous in every output (the
  // groups' lanelinks are), a lane a cell: each store a run of W, the
  // warp's threads (fewer than 32 where the candidates of 4 groups do not
  // fit the shared memory)
  const int W = (int)min(32u, blockDim.x);
  const int ng = W >> lgg;                            // groups a warp
  const int g0 = grp & ~(ng - 1);                     // the warp's first
  const int cells = ng * a.KC;
  const int q = W / a.KC, r = W - q * a.KC;
  const T* D = (const T*)a.d;
  int g = lane / a.KC, kc = lane - g * a.KC;
  for (int cell = lane; cell < cells; cell += W) {
    const int lg = (int)blockIdx.x * groups + g0 + g;
    if (lg < a.LL) {
      const Cand<T>* gc = cands + (g0 + g) * SLOTS;
      const T d = __ldg(D + lg * a.KC + kc);
      // the candidates in the plain version's order: the end vehicle
      // (tail < d), the link's vehicles (tail <= d), the start vehicle
      T best_p = T(-1e30);
      int best = -1;
      if (info[groups + 2 * (g0 + g)] && gc[0].tail < d &&
          gc[0].pk > best_p) {
        best_p = gc[0].pk;
        best = 0;
      }
      const int nk = info[g0 + g];
      for (int i = 2; i < 2 + nk; ++i) {
        if (gc[i].tail <= d && gc[i].pk > best_p) {
          best_p = gc[i].pk;
          best = i;
        }
      }
      if (info[groups + 2 * (g0 + g) + 1] && gc[1].pk > best_p) {
        best_p = gc[1].pk;
        best = 1;
      }
      const Cand<T>& c = gc[best >= 0 ? best : 0];
      const T ndist = d - best_p;
      const int o = (eLL + lg) * a.KC + kc;
      a.exists[o] = best >= 0;
      // canYield (vehicle.cpp:284-287) with the brake distance kept
      a.yld[o] = ((ndist > T(0)) && (c.min_brake < ndist - c.yld)) ||
                 ((ndist < T(0)) && (ndist + c.len < T(0)));
      a.cleared[o] = ndist + c.len < T(0);
      a.cyc_out[o] = c.cyc > T(0);
      a.dpos[o] = ndist > T(0);
      ((T*)a.dist)[o] = ndist;
      a.reach[o] = reach_at(c, ndist, dt);
      a.ent_out[o] = best >= 0 ? c.ent : 0;
      a.pri_out[o] = best >= 0 ? c.pri : 0;
      a.idx[o] = best >= 0 ? c.v : -1;
    }
    g += q;
    kc += r;
    if (kc >= a.KC) {
      kc -= a.KC;
      ++g;
    }
  }
}

extern "C" int notify_cross(const NotifyArgs* args, void* stream) {
  const NotifyArgs a = *args;
  if (a.LL == 0 || a.KC == 0 || a.B == 0) return 0;
  // as many groups a block as fill NC_THREADS and keep their candidates
  // within 48 KB of shared memory (one group past it opts in)
  const size_t per_group = (size_t)(a.K + 2) *
      (a.fp32 ? sizeof(Cand<float>) : sizeof(Cand<double>)) + 3 * 4;
  int groups = NC_THREADS >> NC_LGG;
  while (groups > 1 && groups * per_group > 48 * 1024) groups >>= 1;
  const size_t smem = groups * per_group;
  const dim3 grid((unsigned)((a.LL + groups - 1) / groups), (unsigned)a.B);
  const unsigned threads = (unsigned)groups << NC_LGG;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (a.fp32) {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(notify_cross_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      notify_cross_kernel<float><<<grid, threads, smem, st>>>(a);
  } else {
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(notify_cross_kernel<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e == cudaSuccess)
      notify_cross_kernel<double><<<grid, threads, smem, st>>>(a);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
