// Shared device helpers of the gen-1 kernels (G1-G10), templated on the
// float type: double in exact mode, float in fast mode. Each kernel's
// argument struct ends in `fp32` (1: its float tensors are float32) and
// GEN1_LAUNCH picks the instantiation from it.
//
// Built with --fmad=false and without --use_fast_math: every float op
// rounds on its own (IEEE division and square root), so the kernels repeat
// the plain PyTorch versions op by op and reproduce the reference's double
// arithmetic bit for bit; constants go through T(...), so a float kernel
// never computes in double.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// KERNEL<float> or KERNEL<double>, by ARGS.fp32; the rest is the launch
// configuration (grid, block, shared bytes, stream)
#define GEN1_LAUNCH(KERNEL, ARGS, ...)                \
  do {                                                \
    if ((ARGS).fp32)                                  \
      KERNEL<float><<<__VA_ARGS__>>>(ARGS);           \
    else                                              \
      KERNEL<double><<<__VA_ARGS__>>>(ARGS);          \
  } while (0)

namespace gen1 {

// parameter columns (compiler/net.py P_*)
constexpr int P_LEN = 1, P_MAXNEGACC = 4, P_USUALPOSACC = 5,
              P_USUALNEGACC = 6, P_MAXSPEED = 8, P_YIELD = 10,
              P_TURNSPEED = 11;
// attribute-pack columns (core/step.py A_*)
constexpr int A_DIS = 0, A_LEN = 1, A_SPEED = 2, A_MAXNEG = 3, A_YIELD = 4,
              A_UPA = 5, A_TURNSPD = 6, A_MAXSPD = 7, A_CYC = 8,
              A_PREV = 9;

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// XLA's float -> int32 conversion: saturating, NaN -> 0
template <typename T>
__device__ __forceinline__ int xla_to_i32(T x) {
  if (isnan(x)) return 0;
  if (x >= T(2147483648.0)) return 2147483647;
  if (x < T(-2147483648.0)) return (-2147483647 - 1);
  return (int)x;
}

// torch.minimum: NaN propagates, ties keep the first operand
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (b < a) ? b : a;
}

// The reference's std::min(a, b), (b < a) ? b : a: a NaN in b leaves a.
// getStopBeforeSpeed is 0 / 0 for a stopped vehicle with no distance left;
// the reference keeps the other operand where torch.minimum gives NaN.
template <typename T>
__device__ __forceinline__ T ref_min(T a, T b) {
  return (b < a) ? b : a;
}

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (a < b) ? b : a;
}

// lax.sort's total order as a signed integer key:
// -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < NaN
__device__ __forceinline__ long long order_key(double x) {
  long long b = __double_as_longlong(x);
  return b < 0 ? (b ^ 0x7FFFFFFFFFFFFFFFLL) : b;
}

__device__ __forceinline__ long long order_key(float x) {
  int b = __float_as_int(x);
  return (long long)(b < 0 ? (b ^ 0x7FFFFFFF) : b);
}

// ---- speed model (reference vehicle.cpp; core/step.py of the port) ------

// vehicle.cpp:200-209
template <typename T>
__device__ __forceinline__ T no_collision_speed(T vL, T dL, T vF, T dF, T gap,
                                                T interval, T target_gap) {
  T c = vF * interval / T(2) + target_gap - T(0.5) * vL * vL / dL - gap;
  T a = T(0.5) / dF;
  T b = T(0.5) * interval;
  T disc = b * b - T(4) * a * c;
  T v1 = T(0.5) / a * (sqrt(tmax(disc, T(0))) - b);
  T v2 = T(2) * vL - dL * interval + T(2) * (gap - target_gap) / interval;
  T v = tmin(v1, v2);
  return (b * b < T(4) * a * c) ? T(-100) : v;
}

// Router::getNextDrivable (router.cpp:49-76; core/step.py chain_step): a
// lane's selected lanelink on the route (route_next_ll), a lanelink's end
// lane; -1 off the route. pos advances on a lanelink.
__device__ __forceinline__ int chain_next(const int* route_next_ll,
                                          const int* lane_local,
                                          const int* ll_end, long long L,
                                          long long D, long long NR,
                                          long long RLEN, long long MAXLPR,
                                          int route, int pos, int cur,
                                          int* npos) {
  long long LL = D - L;
  *npos = cur >= L ? pos + 1 : pos;
  if (cur >= 0 && cur < L) {
    long long local = lane_local[clampll(cur, 0, L - 1)];
    long long flat = (clampll(route, 0, NR - 1) * RLEN +
                      clampll(pos, 0, RLEN - 1)) * MAXLPR +
                     clampll(local, 0, MAXLPR - 1);
    return route_next_ll[flat];
  }
  if (cur >= L) return ll_end[clampll(cur - L, 0, LL > 0 ? LL - 1 : 0)];
  return -1;
}

// vehicle.cpp:302-306
template <typename T>
__device__ __forceinline__ T brake_distance_after_accel(T speed, T acc, T dec,
                                                        T interval) {
  T next_speed = speed + acc * interval;
  return (speed + next_speed) * interval / T(2) +
         (next_speed * next_speed / dec / T(2));
}

// vehicle.cpp:240-250 (getStopBeforeSpeed)
template <typename T>
__device__ __forceinline__ T stop_before_speed(T speed, T usual_pos,
                                               T usual_neg, T distance,
                                               T interval) {
  T bda = brake_distance_after_accel(speed, usual_pos, usual_neg, interval);
  T ti = T(2) * distance / (speed + T(1e-8)) / interval;
  // (int)takeInterval: C truncation; x86 cvttsd2si out of range -> INT_MIN
  T ti_int = (fabs(ti) >= T(2147483648.0)) ? T(-2147483648.0) : trunc(ti);
  T ge1 = speed - speed / ti_int;
  T lt1 = speed - speed / ti;
  T slow = (ti >= T(1)) ? ge1 : lt1;
  return (bda < distance) ? speed + usual_pos * interval : slow;
}

// vehicle.cpp:275-282 (stage1speed adds acc/interval, as written there)
template <typename T>
__device__ __forceinline__ T distance_until_speed(T speed, T target, T acc,
                                                  T interval) {
  T s1 = floor((target - speed) / acc / interval);
  T v1 = speed + s1 * acc / interval;
  T d1 = (speed + v1) * (s1 * interval) / T(2);
  T d = d1 + ((v1 < target) ? (v1 + target) * interval / T(2) : T(0));
  return (target <= speed) ? T(0) : d;
}

// vehicle.cpp:252-268 (getReachSteps)
template <typename T>
__device__ __forceinline__ int reach_steps(T speed, T distance, T target,
                                           T acc, T interval) {
  T r_fast = ceil(distance / ((speed > T(0)) ? speed : T(1)));
  T dts = distance_until_speed(speed, target, acc, interval);
  T r_a = ceil((sqrt(tmax(speed * speed + T(2) * acc * distance, T(0))) -
                speed) / acc / interval);
  T r_b = ceil((target - speed) / acc / interval) +
          ceil((distance - dts) / target / interval);
  T r = (speed > target) ? r_fast : ((dts > distance) ? r_a : r_b);
  r = (distance <= T(0)) ? T(0) : r;
  return xla_to_i32(r);
}

// vehicle.cpp:284-287
template <typename T>
__device__ __forceinline__ bool can_yield(T speed, T max_neg, T yield_dist,
                                          T length, T d) {
  T min_brake = T(0.5) * speed * speed / max_neg;
  return ((d > T(0)) && (min_brake < d - yield_dist)) ||
         ((d < T(0)) && (d + length < T(0)));
}

// One block: y[i] = x[0] + ... + x[i-1] for i in [0, n], each thread
// summing a contiguous chunk, the chunk sums scanned in shared memory
// (sh: blockDim.x ints).
template <typename X>
__device__ void block_exclusive_scan(const X* x, int* y, long long n,
                                     int* sh) {
  int t = threadIdx.x, nt = blockDim.x;
  long long chunk = (n + nt - 1) / nt;
  long long lo = t * chunk;
  long long hi = lo + chunk < n ? lo + chunk : n;
  int s = 0;
  for (long long i = lo; i < hi; ++i) s += (int)x[i];
  sh[t] = s;
  __syncthreads();
  for (int o = 1; o < nt; o <<= 1) {
    int add = (t >= o) ? sh[t - o] : 0;
    __syncthreads();
    sh[t] += add;
    __syncthreads();
  }
  int run = sh[t] - s;
  for (long long i = lo; i < hi; ++i) {
    y[i] = run;
    run += (int)x[i];
  }
  if (t == nt - 1) y[n] = sh[nt - 1];
  __syncthreads();
}

__host__ __device__ __forceinline__ unsigned grid_blocks(long long n,
                                                         int threads) {
  long long b = (n + threads - 1) / threads;
  if (b > 65535LL * 32) b = 65535LL * 32;
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace gen1
