// G3 notify_cross: Engine::threadNotifyCross (reference engine.cpp:317-372)
// for every (lanelink, cross slot): the notifier, i.e. the candidate with
// the largest front position whose tail has not cleared the cross, and the
// terms Cross::canPass reads about it (roadnet.cpp:604-660).
//
// Replaces notify_cross in cityflow_tpu/core/step.py (:467-594), which the
// TPU runs in (KC, LL) layout as a K2 = k_link + 2 round where-chain, a
// one-hot einsum on the MXU to fetch the winner's 10 float channels, and a
// static permutation (lnk_cross_foe_pos) to the foe side. Here one thread
// owns one (link, slot): it walks the K2 candidates (the end lane's rear
// vehicle, the link's first k_link vehicles from G1's table, the start
// lane's front vehicle) keeping the first strict maximum, reads the
// winner's channels directly and writes the own-side row. No permutation
// pass runs: G4 reads the foe side through lnk_cross_foe_pos.
//
// Bound: bytes. A thread reads its cross distance, the link's table row
// (k_link x 12 values) and two vehicles' packs, and writes 10 values.
#include "gen1.cuh"

using namespace gen1;

struct NotifyArgs {
  const void* d;            // (LL, KC) T cross distance on the link
  const void* drv_len;      // (D,) T
  const int* ll_end;        // (LL,)
  const int* ll_start;      // (LL,)
  const uint8_t* ll_is_turn;  // (LL,)
  const int* last_of;       // (D,)
  const int* first_of;      // (D,)
  const int* veh_next;      // (V,)
  const uint8_t* ll_avail;  // (LL,)
  const void* fattrs;       // (V, NA) T
  const int* iattrs;        // (V, NI)
  const int* link_veh;      // (LL, K)
  const void* link_fattr;   // (LL, K, NA) T
  const int* link_iattr;    // (LL, K, NI)
  const void* interval;     // () T
  uint8_t* exists;          // (LL, KC) each
  uint8_t* yld;
  uint8_t* cleared;
  uint8_t* cyc;
  uint8_t* dpos;
  void* dist;               // T
  int* reach;
  int* ent;
  int* pri;
  int* idx;
  long long LL, KC, K, NA, NI, V, L, fp32;
};

template <typename T>
__global__ void notify_cross_kernel(const NotifyArgs a) {
  const T* D = (const T*)a.d;
  const T* drv_len = (const T*)a.drv_len;
  const T* fattrs = (const T*)a.fattrs;
  const T* lfat = (const T*)a.link_fattr;
  const T dt = *(const T*)a.interval;
  long long total = a.LL * a.KC;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long l = e / a.KC;
    T d = D[e];
    T ll_len = drv_len[a.L + l];
    int last_slot = a.last_of[a.ll_end[l]];
    long long ls = clampll(last_slot, 0, a.V - 1);
    const T* lfa = fattrs + ls * a.NA;
    const int* lia = a.iattrs + ls * a.NI;
    int first_slot = a.first_of[a.ll_start[l]];
    long long fs = clampll(first_slot, 0, a.V - 1);
    const T* ffa = fattrs + fs * a.NA;
    const int* fia = a.iattrs + fs * a.NI;
    int l_drv = (int)(a.L + l);
    bool e_ok = last_slot >= 0 && xla_to_i32(lfa[A_PREV]) == l_drv;
    bool s_ok = first_slot >= 0 && a.veh_next[fs] == l_drv &&
                a.ll_avail[l] != 0;

    T best_p = T(-1e30);
    int best_v = -1, best_ent = 0, best_pri = 0;
    const T* bfa = lfa;  // the winner's pack (candidate 0 when none)
    // candidate 0: the end lane's rear vehicle, still on this link
    if (e_ok && ll_len + lfa[A_DIS] - lfa[A_LEN] < d) {
      T pk = ll_len + lfa[A_DIS];
      if (pk > best_p) {
        best_p = pk;
        best_v = last_slot;
        best_ent = lia[0];
        best_pri = lia[1];
      }
    }
    // candidates 1..K: the link's vehicles front to back
    for (long long j = 0; j < a.K; ++j) {
      long long row = l * a.K + j;
      int lv = a.link_veh[row];
      const T* fa = lfat + row * a.NA;
      if (lv >= 0 && fa[A_DIS] - fa[A_LEN] <= d) {
        T pk = fa[A_DIS];
        if (pk > best_p) {
          best_p = pk;
          best_v = lv;
          best_ent = a.link_iattr[row * a.NI];
          best_pri = a.link_iattr[row * a.NI + 1];
          bfa = fa;
        }
      }
    }
    // candidate K + 1: the start lane's front vehicle, about to enter
    if (s_ok) {
      T pk = -(drv_len[a.ll_start[l]] - ffa[A_DIS]);
      if (pk > best_p) {
        best_p = pk;
        best_v = first_slot;
        best_ent = fia[0];
        best_pri = fia[1];
        bfa = ffa;
      }
    }
    T ndist = d - best_p;
    T target = a.ll_is_turn[l] ? bfa[A_TURNSPD] : bfa[A_MAXSPD];
    a.exists[e] = best_v >= 0;
    a.yld[e] = can_yield(bfa[A_SPEED], bfa[A_MAXNEG], bfa[A_YIELD],
                         bfa[A_LEN], ndist);
    a.cleared[e] = ndist + bfa[A_LEN] < T(0);
    a.cyc[e] = bfa[A_CYC] > T(0);
    a.dpos[e] = ndist > T(0);
    ((T*)a.dist)[e] = ndist;
    a.reach[e] = reach_steps(bfa[A_SPEED], ndist, target, bfa[A_UPA], dt);
    a.ent[e] = best_ent;
    a.pri[e] = best_pri;
    a.idx[e] = best_v;
  }
}

extern "C" int notify_cross(const NotifyArgs* args, void* stream) {
  const NotifyArgs a = *args;
  long long total = a.LL * a.KC;
  if (total == 0) return 0;
  const int threads = 128;
  GEN1_LAUNCH(notify_cross_kernel, a, grid_blocks(total, threads), threads,
                                      0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
