// T1 tpl_params: a vehicle template index -> the requested columns of its
// template's parameter row, for every element of an int32 index tensor.
//
// Replaces _PP in cityflow_tpu/core/ring.py (:270-297): there a one-hot of
// the index over the TP templates contracts with tpl_params (TP, 12) on the
// MXU (precision HIGHEST). With one 1 per row and finite parameters that
// einsum is an exact selection, and an index outside [0, TP) gives a row of
// zeros; so is this. The table is tiny (TP rows of 12 floats): each block
// copies the requested columns into shared memory, then one thread per
// element writes its ncols values.
//
// out[c * n + e] = table[tpl[e] * 12 + cols[c]]   (0 <= tpl[e] < TP)
//                = 0                             (otherwise)
//
// Bound: bytes. 4 bytes of index in and 4 * ncols out per element; no
// arithmetic.
#include "common.cuh"

#define TPL_NPARAM 12

struct TplParamsArgs {
  const int* tpl;       // (n,)
  const float* table;   // (TP, 12)
  float* out;           // (ncols, n)
  long long n;
  int TP;
  int ncols;
  int cols[TPL_NPARAM];
};

__global__ void tpl_params_kernel(const TplParamsArgs a) {
  extern __shared__ float sh[];   // (TP, ncols)
  for (int i = threadIdx.x; i < a.TP * a.ncols; i += blockDim.x)
    sh[i] = a.table[(i / a.ncols) * TPL_NPARAM + a.cols[i % a.ncols]];
  __syncthreads();
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < a.n; e += (long long)gridDim.x * blockDim.x) {
    int t = a.tpl[e];
    bool ok = t >= 0 && t < a.TP;
    for (int c = 0; c < a.ncols; ++c)
      a.out[c * a.n + e] = ok ? sh[t * a.ncols + c] : 0.0f;
  }
}

extern "C" int tpl_params(const TplParamsArgs* args, void* stream) {
  if (args->n == 0) return 0;
  if (args->ncols < 1 || args->ncols > TPL_NPARAM || args->TP < 1) return -1;
  size_t smem = (size_t)args->TP * args->ncols * sizeof(float);
  if (smem > 48 * 1024) return -1;
  int threads = 256;
  long long blocks = (args->n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  tpl_params_kernel<<<(unsigned)blocks, threads, smem,
                      (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
