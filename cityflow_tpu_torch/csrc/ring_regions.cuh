// Helpers shared by the ring step's region kernels R1-R4
// (notify_winners, ring_exits, ring_admit, route_rows).
#pragma once

#include "common.cuh"

namespace rr {

// parameter columns of the template table (compiler/net.py P_*)
enum {
  P_SPEED = 0, P_LEN, P_WIDTH, P_MAXPOSACC, P_MAXNEGACC, P_USUALPOSACC,
  P_USUALNEGACC, P_MINGAP, P_MAXSPEED, P_HEADWAY, P_YIELD, P_TURNSPEED,
  P_N
};

// column `col` of template t's row; 0 outside [0, TP), as T1 and the JAX
// one-hot einsum give there
__device__ __forceinline__ float tparam(const float* table, long long TP,
                                        int t, int col) {
  return (t >= 0 && t < TP) ? __ldg(&table[t * P_N + col]) : 0.0f;
}

// the (hi, lo) 16-bit halves of a priority as floats (ring.py _hilo)
__device__ __forceinline__ float pri_hi(int p) { return (float)(p >> 16); }
__device__ __forceinline__ float pri_lo(int p) { return (float)(p & 0xFFFF); }

// an int that crossed a float exchange: the plain versions carry it as
// float32 and convert back with XLA's saturating cast
__device__ __forceinline__ int via_f32(int v) {
  return xla_f32_to_i32((float)v);
}

__host__ __forceinline__ unsigned grid_for(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace rr
