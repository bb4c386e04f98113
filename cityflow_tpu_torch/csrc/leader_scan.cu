// G2 leader_scan: Vehicle::updateLeaderAndGap's scan past the end of the
// vehicle's drivable (reference vehicle.cpp:157-196) for the vehicles with
// no leader on their own drivable.
//
// Replaces leader_scan in cityflow_tpu/core/step.py (:242-322, exact
// branch), which the TPU runs as k_scan x k_out rounds of (V,) gathers over
// every slot. Here one thread walks one masked vehicle's route: up to
// k_scan hops of the router chain; on a lane the candidate is its rear
// vehicle, on a lanelink the rear vehicle of every lanelink leaving the
// same start lane, the smallest gap first (strict <). It stops at the
// first hit, at the route's end or past the brake bound, so the work
// follows what the data needs.
//
// Fast mode replaces the fast branch of the same function (:262-286,
// :311-314): a first kernel builds the per-drivable table (candidate,
// dis - len) over all D drivables, one thread each (a lanelink's entry is
// the least dis - len over the lanelinks leaving its start lane, strict
// <); the scan kernel then reads one table entry per hop and its gap is
// dis_rem + (dis - len). Both kernels run in one call, in stream order.
//
// Bound: bytes, and at these sizes launch latency: a thread reads its
// vehicle's state and params and, per hop, a route entry and a few rear
// vehicles' distance and length (fast mode: one table entry).
#include "gen1.cuh"

using namespace gen1;

struct LeaderScanArgs {
  const uint8_t* mask;          // (V,)
  const int* drv;               // (V,)
  const int* route;             // (V,)
  const int* route_pos;         // (V,)
  const void* dis;              // (V,) T
  const void* params;           // (V, NP) T
  const int* last_of;           // (D,)
  const void* drv_len;          // (D,) T
  const int* ll_start;          // (LL,)
  const int* ll_end;            // (LL,)
  const int* lane_out;          // (L, KO) global drivable index, -1 pad
  const int* lane_local;        // (L,)
  const int* route_next_ll;     // (NR, RLEN, MAXLPR)
  const void* interval;         // () T
  int* found;                   // (V,) leader slot or -1
  void* gap;                    // (V,) T
  int* cand_i;                  // (D,) fast mode: the table's candidate
  void* cand_v;                 // (D,) T fast mode: its dis - len
  long long V, L, D, KO, NR, RLEN, MAXLPR, k_scan, NP, fast, fp32;
};

// router.cpp:49-76 (core/step.py chain_step)
__device__ __forceinline__ void chain_step(const LeaderScanArgs& a, int route,
                                           int pos, int cur, int* nxt,
                                           int* npos) {
  long long LL = a.D - a.L;
  long long lane_local = a.lane_local[clampll(cur, 0, a.L - 1)];
  long long flat = (clampll(route, 0, a.NR - 1) * a.RLEN +
                    clampll(pos, 0, a.RLEN - 1)) * a.MAXLPR +
                   clampll(lane_local, 0, a.MAXLPR - 1);
  if (cur >= 0 && cur < a.L) {
    *nxt = a.route_next_ll[flat];
  } else if (cur >= a.L) {
    *nxt = a.ll_end[clampll(cur - a.L, 0, LL > 0 ? LL - 1 : 0)];
  } else {
    *nxt = -1;
  }
  *npos = cur >= a.L ? pos + 1 : pos;
}

// fast mode: each drivable's (candidate, dis - len)
template <typename T>
__global__ void cand_table_kernel(const LeaderScanArgs a) {
  const T* dis = (const T*)a.dis;
  const T* P = (const T*)a.params;
  T* cand_v = (T*)a.cand_v;
  long long LL = a.D - a.L;
  for (long long d = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       d < a.D; d += (long long)gridDim.x * blockDim.x) {
    int bc = -1;
    T bv = T(0);
    if (d < a.L) {
      bc = a.last_of[d];
      if (bc >= 0) bv = dis[bc] - P[bc * a.NP + P_LEN];
    } else {
      long long sl = a.ll_start[clampll(d - a.L, 0, LL - 1)];
      sl = clampll(sl, 0, a.L - 1);
      for (long long k = 0; k < a.KO; ++k) {
        int ol = a.lane_out[sl * a.KO + k];
        if (ol < 0) continue;
        int c = a.last_of[clampll(ol, 0, a.D - 1)];
        if (c < 0) continue;
        T val = dis[c] - P[c * a.NP + P_LEN];
        if (bc < 0 || val < bv) {
          bc = c;
          bv = val;
        }
      }
    }
    a.cand_i[d] = bc;
    cand_v[d] = bv;
  }
}

template <typename T>
__global__ void leader_scan_kernel(const LeaderScanArgs a) {
  const T* dis = (const T*)a.dis;
  const T* P = (const T*)a.params;
  const T* drv_len = (const T*)a.drv_len;
  T* gap = (T*)a.gap;
  const T dt = *(const T*)a.interval;
  long long LL = a.D - a.L;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    int fnd = -1;
    T fg = T(0);
    if (a.mask[v]) {
      T ms = P[v * a.NP + P_MAXSPEED];
      T bound = ms * ms / P[v * a.NP + P_USUALNEGACC] / T(2) + ms * dt * T(2);
      int cur = a.drv[v], pos = a.route_pos[v], route = a.route[v];
      T dis_rem = drv_len[clampll(cur, 0, a.D - 1)] - dis[v];
      for (long long h = 0; h < a.k_scan; ++h) {
        int nd, np;
        chain_step(a, route, pos, cur, &nd, &np);
        pos = np;
        if (nd < 0) break;
        int cand = -1;
        T cgap = T(0);
        if (a.fast) {
          cand = a.cand_i[nd];
          cgap = dis_rem + ((const T*)a.cand_v)[nd];
        } else if (nd >= a.L) {
          // every lanelink leaving the same start lane (vehicle.cpp:170-180)
          long long sl = a.ll_start[clampll(nd - a.L, 0, LL - 1)];
          sl = clampll(sl, 0, a.L - 1);
          for (long long k = 0; k < a.KO; ++k) {
            int ol = a.lane_out[sl * a.KO + k];
            if (ol < 0) continue;
            int c = a.last_of[clampll(ol, 0, a.D - 1)];
            if (c < 0) continue;
            T g = dis_rem + dis[c] - P[c * a.NP + P_LEN];
            if (cand < 0 || g < cgap) {
              cand = c;
              cgap = g;
            }
          }
        } else {
          cand = a.last_of[nd];
          if (cand >= 0) cgap = dis_rem + dis[cand] - P[cand * a.NP + P_LEN];
        }
        if (cand >= 0) {
          fnd = cand;
          fg = cgap;
          break;
        }
        dis_rem = dis_rem + drv_len[nd];
        if (dis_rem > bound) break;
        cur = nd;
      }
    }
    a.found[v] = fnd;
    gap[v] = fg;
  }
}

extern "C" int leader_scan(const LeaderScanArgs* args, void* stream) {
  const LeaderScanArgs a = *args;
  if (a.V == 0) return 0;
  const int threads = 128;
  if (a.fast)
    GEN1_LAUNCH(cand_table_kernel, a, grid_blocks(a.D, threads), threads, 0,
                (cudaStream_t)stream);
  GEN1_LAUNCH(leader_scan_kernel, a, grid_blocks(a.V, threads), threads,
                                     0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
