// T1 tpl_params: a vehicle template index -> the requested columns of its
// template's parameter row, for every element of an int32 index tensor.
//
// Replaces _PP in cityflow_tpu/core/ring.py (:270-297): there a one-hot of
// the index over the TP templates contracts with tpl_params (TP, 12) on the
// MXU (precision HIGHEST). With one 1 per row and finite parameters that
// einsum is an exact selection, and an index outside [0, TP) gives a row of
// zeros; so is this.
//
// out[c * n + e] = table[tpl[e] * 12 + cols[c]]   (0 <= tpl[e] < TP)
//                = +0.0                          (otherwise)
//
// Bound: bytes. 4 bytes of index in and 4 * ncols out per element; no
// arithmetic. The design keeps enough bytes in flight to reach it: a grid
// of a few resident blocks per SM walks the elements with a grid stride;
// each block first copies the requested columns (TP x ncols floats, at
// most 48 KB) into shared memory; each thread then loads TPL_UNROLL
// 16-byte words of four indices before it writes any of their 16-byte
// output words (one per column). The columns come packed 4 bits each in
// one 64-bit word, so no parameter array is indexed at run time. Where
// n % 4 != 0 or the index or output pointer is not 16-byte aligned, the
// same loop runs on single elements.
#include "common.cuh"

#define TPL_NPARAM 12
#define TPL_UNROLL 4

struct TplParamsArgs {
  const int* tpl;       // (n,)
  const float* table;   // (TP, 12)
  float* out;           // (ncols, n)
  long long n;
  int TP;
  int ncols;
  unsigned long long cols;        // column c in bits 4c .. 4c + 3
};

namespace {

__device__ __forceinline__ float tpl_val(const float* sh, int TP, int nc,
                                         int t, int c) {
  return (unsigned)t < (unsigned)TP ? sh[t * nc + c] : 0.0f;
}

template <bool VEC>
__global__ void __launch_bounds__(256)
tpl_params_kernel(const TplParamsArgs a) {
  extern __shared__ float sh[];   // (TP, ncols)
  const int TP = a.TP, nc = a.ncols;
  for (int i = threadIdx.x; i < TP * nc; i += blockDim.x) {
    const int t = i / nc;
    const int col = (int)((a.cols >> (4 * (i - t * nc))) & 15u);
    sh[i] = a.table[t * TPL_NPARAM + col];
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (VEC) {
    // four elements a word: n % 4 == 0, tpl and out 16-byte aligned
    const long long nq = a.n >> 2;
    const int4* tq = reinterpret_cast<const int4*>(a.tpl);
    for (long long q0 = tid; q0 < nq; q0 += TPL_UNROLL * step) {
      int4 t[TPL_UNROLL];
#pragma unroll
      for (int u = 0; u < TPL_UNROLL; ++u) {
        const long long q = q0 + u * step;
        if (q < nq) t[u] = __ldg(tq + q);
      }
#pragma unroll
      for (int u = 0; u < TPL_UNROLL; ++u) {
        const long long q = q0 + u * step;
        if (q >= nq) continue;
        float4* o = reinterpret_cast<float4*>(a.out) + q;
        for (int c = 0; c < nc; ++c, o += nq)
          *o = make_float4(tpl_val(sh, TP, nc, t[u].x, c),
                           tpl_val(sh, TP, nc, t[u].y, c),
                           tpl_val(sh, TP, nc, t[u].z, c),
                           tpl_val(sh, TP, nc, t[u].w, c));
      }
    }
  } else {
    for (long long e0 = tid; e0 < a.n; e0 += TPL_UNROLL * step) {
      int t[TPL_UNROLL];
#pragma unroll
      for (int u = 0; u < TPL_UNROLL; ++u) {
        const long long e = e0 + u * step;
        if (e < a.n) t[u] = __ldg(a.tpl + e);
      }
#pragma unroll
      for (int u = 0; u < TPL_UNROLL; ++u) {
        const long long e = e0 + u * step;
        if (e >= a.n) continue;
        for (int c = 0; c < nc; ++c)
          a.out[c * a.n + e] = tpl_val(sh, TP, nc, t[u], c);
      }
    }
  }
}

// the card's SM count (cached after the first query)
cudaError_t sm_count(int* n) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    int v = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cached = v;
  }
  *n = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" int tpl_params(const TplParamsArgs* args, void* stream) {
  if (args->n == 0) return 0;
  if (args->ncols < 1 || args->ncols > TPL_NPARAM || args->TP < 1)
    return -1;
  const size_t smem = (size_t)args->TP * args->ncols * sizeof(float);
  if (smem > 48 * 1024) return -1;
  const bool vec = args->n % 4 == 0 &&
                   (uintptr_t)args->tpl % 16 == 0 &&
                   (uintptr_t)args->out % 16 == 0;
  const int threads = 256;
  int sms = 0, per_sm = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  e = vec ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, tpl_params_kernel<true>, threads, smem)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, tpl_params_kernel<false>, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  // one wave of resident blocks, fewer where n is small
  const long long words = vec ? args->n / 4 : args->n;
  long long blocks = (words + threads - 1) / threads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (vec)
    tpl_params_kernel<true><<<(unsigned)blocks, threads, smem,
                              (cudaStream_t)stream>>>(*args);
  else
    tpl_params_kernel<false><<<(unsigned)blocks, threads, smem,
                               (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
