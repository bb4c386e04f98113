// Shared device helpers for the ring-step kernels.
//
// Built with --fmad=false and without --use_fast_math: every float op
// rounds on its own (IEEE division and square root), so the kernels repeat
// the plain PyTorch versions op by op and the integer decisions taken on
// floats (reach_steps -> ceil -> int) cannot flip on a contracted multiply-add.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// XLA's float -> int32 conversion: saturating, NaN -> 0. A plain C cast is
// undefined out of range (and gives INT_MIN on the card); the JAX reference
// relies on the saturation, e.g. f32(INT_MAX) = 2^31 must come back as
// INT_MAX on every empty link slot.
__device__ __forceinline__ int xla_f32_to_i32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x <= -2147483648.0f) return (-2147483647 - 1);
  return (int)x;
}

// torch.minimum / torch.maximum: NaN propagates, ties keep the first operand
// (std::min / std::max).
__device__ __forceinline__ float tmin(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (b < a) ? b : a;
}

__device__ __forceinline__ float tmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (a < b) ? b : a;
}

// The reference's std::min(a, b), (b < a) ? b : a: a NaN in b leaves a.
// The speed chain's `v = min(v, getStopBeforeSpeed(...))` (vehicle.cpp
// getIntersectionRelatedSpeed) meets 0 / 0 = NaN there for a stopped
// vehicle with no distance left; the reference keeps v.
__device__ __forceinline__ float ref_min(float a, float b) {
  return (b < a) ? b : a;
}

// ---- speed model (reference vehicle.cpp; core/step.py of the port) ------

// vehicle.cpp:200-209
__device__ __forceinline__ float no_collision_speed(float vL, float dL,
                                                    float vF, float dF,
                                                    float gap, float interval,
                                                    float target_gap) {
  float c = vF * interval / 2.0f + target_gap - 0.5f * vL * vL / dL - gap;
  float a = 0.5f / dF;
  float b = 0.5f * interval;
  float disc = b * b - 4.0f * a * c;
  float v1 = 0.5f / a * (sqrtf(tmax(disc, 0.0f)) - b);
  float v2 = 2.0f * vL - dL * interval + 2.0f * (gap - target_gap) / interval;
  float v = tmin(v1, v2);
  return (b * b < 4.0f * a * c) ? -100.0f : v;
}

// vehicle.cpp:302-306
__device__ __forceinline__ float brake_distance_after_accel(float speed,
                                                            float acc,
                                                            float dec,
                                                            float interval) {
  float next_speed = speed + acc * interval;
  return (speed + next_speed) * interval / 2.0f +
         (next_speed * next_speed / dec / 2.0f);
}

// vehicle.cpp:240-250 (getStopBeforeSpeed)
__device__ __forceinline__ float stop_before_speed(float speed,
                                                   float usual_pos,
                                                   float usual_neg,
                                                   float distance,
                                                   float interval) {
  float bda = brake_distance_after_accel(speed, usual_pos, usual_neg, interval);
  float ti = 2.0f * distance / (speed + 1e-8f) / interval;
  // (int)takeInterval: C truncation; x86 cvttsd2si out of range -> INT_MIN
  float ti_int = (fabsf(ti) >= 2147483648.0f) ? -2147483648.0f : truncf(ti);
  float ge1 = speed - speed / ti_int;
  float lt1 = speed - speed / ti;
  float slow = (ti >= 1.0f) ? ge1 : lt1;
  return (bda < distance) ? speed + usual_pos * interval : slow;
}

// vehicle.cpp:275-282 (stage1speed adds acc/interval, as written there)
__device__ __forceinline__ float distance_until_speed(float speed,
                                                      float target, float acc,
                                                      float interval) {
  float s1 = floorf((target - speed) / acc / interval);
  float v1 = speed + s1 * acc / interval;
  float d1 = (speed + v1) * (s1 * interval) / 2.0f;
  float d = d1 + ((v1 < target) ? (v1 + target) * interval / 2.0f : 0.0f);
  return (target <= speed) ? 0.0f : d;
}

// vehicle.cpp:252-268 (getReachSteps)
__device__ __forceinline__ int reach_steps(float speed, float distance,
                                           float target, float acc,
                                           float interval) {
  float r_fast = ceilf(distance / ((speed > 0.0f) ? speed : 1.0f));
  float dts = distance_until_speed(speed, target, acc, interval);
  float r_a = ceilf((sqrtf(tmax(speed * speed + 2.0f * acc * distance, 0.0f)) -
                     speed) / acc / interval);
  float r_b = ceilf((target - speed) / acc / interval) +
              ceilf((distance - dts) / target / interval);
  float r = (speed > target) ? r_fast : ((dts > distance) ? r_a : r_b);
  r = (distance <= 0.0f) ? 0.0f : r;
  return xla_f32_to_i32(r);
}

// vehicle.cpp:284-287
__device__ __forceinline__ bool can_yield(float speed, float max_neg,
                                          float yield_dist, float length,
                                          float d) {
  float min_brake = 0.5f * speed * speed / max_neg;
  return ((d > 0.0f) && (min_brake < d - yield_dist)) ||
         ((d < 0.0f) && (d + length < 0.0f));
}
