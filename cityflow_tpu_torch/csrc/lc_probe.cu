// G6 lc_probe: the neighbour probe of gen-1 lane change
// (SimpleLaneChange's getVehicleAfter/BeforeDistance, reference
// lanechange.cpp:27-60): for every running lane vehicle, on its outer lane
// (local index + 1) and inner lane (local index - 1), the leader (the
// nearest vehicle at distance >= its own) and the follower (the nearest
// at distance < its own).
//
// Replaces _probe_neighbors in cityflow_tpu/core/lanechange.py (:42-96),
// which the TPU answers with one stable 3V lax.sort of vehicles and
// probes keyed (lane, -dis, kind, slot) and cummax / cummin fills. Here
// one thread owns one vehicle and, per side, walks the target lane's
// members along G1's leader chain from the rear (last_of) and keeps the
// best candidate under the order the sort induces: the leader has the
// largest -dis key <= the probe's (ties: the largest slot, as vehicles
// sort by slot and the probe comes after them), the follower the smallest
// key > the probe's (ties: the smallest slot). Keys are lax.sort's total
// order of -dis, so -0.0 and NaN order as there.
//
// Bound: bytes. Per vehicle its state and two lane walks, each member's
// distance and leader read (12 bytes a member); six int32 outputs.
#include "gen1.cuh"

using namespace gen1;

struct LcProbeArgs {
  const uint8_t* running;   // (V,)
  const int* drv;           // (V,)
  const void* dis;          // (V,) T
  const int* lane_local;    // (L,)
  const int* lane_road;     // (L,)
  const int* road_num_lanes;  // (R,)
  const int* last_of;       // (D,) G1's rear vehicle per drivable
  const int* leader;        // (V,) G1's vehicle ahead
  int* outer_lane;          // (V,) L: none
  int* inner_lane;
  int* outer_leader;        // (V,) -1: none
  int* outer_follower;
  int* inner_leader;
  int* inner_follower;
  long long V, L, R, fp32;
};

template <typename T>
__device__ __forceinline__ void probe(const LcProbeArgs& a, const T* dis,
                                      int lane, long long key_p, int* lead,
                                      int* foll) {
  int bl = -1, bf = -1;
  long long kl = 0, kf = 0;
  int guard = 0;
  for (int u = a.last_of[lane]; u >= 0 && guard < a.V; u = a.leader[u]) {
    ++guard;
    long long ku = order_key(-dis[u]);
    if (ku <= key_p) {
      if (bl < 0 || ku > kl || (ku == kl && u > bl)) {
        bl = u;
        kl = ku;
      }
    } else if (bf < 0 || ku < kf || (ku == kf && u < bf)) {
      bf = u;
      kf = ku;
    }
  }
  *lead = bl;
  *foll = bf;
}

template <typename T>
__global__ void lc_probe_kernel(const LcProbeArgs a) {
  const T* dis = (const T*)a.dis;
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    int d = a.drv[v];
    bool on_lane = a.running[v] && d >= 0 && d < a.L;
    long long ds = clampll(d, 0, a.L - 1);
    int local = a.lane_local[ds];
    int n_in = a.road_num_lanes[clampll(a.lane_road[ds], 0, a.R - 1)];
    int outer = (on_lane && local + 1 < n_in) ? d + 1 : (int)a.L;
    int inner = (on_lane && local > 0) ? d - 1 : (int)a.L;
    long long key_p = order_key(-dis[v]);
    int ol = -1, of = -1, il = -1, inf_ = -1;
    if (outer < a.L) probe<T>(a, dis, outer, key_p, &ol, &of);
    if (inner < a.L) probe<T>(a, dis, inner, key_p, &il, &inf_);
    a.outer_lane[v] = outer;
    a.inner_lane[v] = inner;
    a.outer_leader[v] = ol;
    a.outer_follower[v] = of;
    a.inner_leader[v] = il;
    a.inner_follower[v] = inf_;
  }
}

extern "C" int lc_probe(const LcProbeArgs* args, void* stream) {
  const LcProbeArgs a = *args;
  if (a.V == 0) return 0;
  const int threads = 128;
  GEN1_LAUNCH(lc_probe_kernel, a, grid_blocks(a.V, threads), threads,
                                  0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
