// G9 blocker_cycles: Cross::canPass's deadlock test (reference
// roadnet.cpp:662-674) for every slot at once: is a cycle of the blocker
// graph reachable from the slot?
//
// Replaces blocker_cycles in cityflow_tpu/core/step.py (:597-615), which
// the TPU computes as log2(S) pointer-doubling squarings of the blocker
// map f (-1 absorbing), one (V,) gather each, and reads f^S(v) >= 0. S is
// the first power of two >= limit: limit = V in exact mode, and
// min(V, 2^min(k_chase, 10)) in fast mode. Here one thread walks one
// slot's chain:
//   fast   at most S <= 1024 hops: alive after S hops is f^S(v) >= 0;
//   exact  until -1 (no cycle: false) or until Brent's cycle finder meets
//          a cycle (true). The graph is functional, so a chain with no
//          cycle ends within V - 1 <= S hops, and a chain into a cycle
//          never ends: the answer equals f^S(v) >= 0 exactly, in
//          mu + lambda hops (tail plus cycle length) instead of S.
// One launch, where the doubling takes log2(S) gathers over all V slots.
//
// Bound: bytes. A thread reads one blocker per hop and writes one flag;
// the hops follow the data (most slots have no blocker: one read).
#include "gen1.cuh"

struct BlockerCyclesArgs {
  const int* blocker;   // (V,) the blocking slot, -1 for none
  uint8_t* out;         // (V,) a cycle is reachable (alive after S hops)
  long long V, S, exact;
};

__global__ void blocker_cycles_kernel(const BlockerCyclesArgs a) {
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < a.V; v += (long long)gridDim.x * blockDim.x) {
    bool alive;
    if (a.exact) {
      // Brent: the hare runs ahead, the tortoise jumps to it at each
      // power of two; they meet once both are on the cycle
      int tortoise = (int)v, hare = a.blocker[v];
      long long power = 1, lam = 1;
      while (hare >= 0 && hare != tortoise) {
        if (power == lam) {
          tortoise = hare;
          power *= 2;
          lam = 0;
        }
        hare = a.blocker[hare];
        ++lam;
      }
      alive = hare >= 0;
    } else {
      int x = (int)v;
      for (long long s = 0; s < a.S && x >= 0; ++s) x = a.blocker[x];
      alive = x >= 0;
    }
    a.out[v] = alive;
  }
}

extern "C" int blocker_cycles(const BlockerCyclesArgs* args, void* stream) {
  const BlockerCyclesArgs a = *args;
  if (a.V == 0) return 0;
  const int threads = 128;
  blocker_cycles_kernel<<<gen1::grid_blocks(a.V, threads), threads, 0,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
