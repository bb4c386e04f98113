// K1 gather_rows: out[c, j, b] = idx[j] >= 0 ? x[c, idx[j], b] : fill.
//
// Replaces the one-hot operators of cityflow_tpu/core/ring.py: the lane <->
// in-lane exchanges and their shift plans (:300-341, :686-744), the typed
// one-hot einsums _typed_mm (:243-250) over E_start / E_end / E_rl / E_out /
// E_app, the E_el admission spread (:531-544) and the foe_perm / foe_gather
// exchange (:881-927). Each one-hot row holds at most one 1 (asserted when
// the index tables are built), so the einsum is exactly this gather. (The
// ring step reads the foe exchange in place inside K2 and packs its
// dynamic to_link / from_link selections in R5 / R7; K1 keeps the static
// bundles.)
//
// Bound: bytes. Every output element is one 4-byte read and one 4-byte
// write; the index is read once per row j. A (c, j) row is B contiguous
// words on both sides, so the kernel copies rows: tpr threads per row
// (B = 128 floats: a warp, each thread one 16-byte word), a thread block
// tiles rows of j, and each j's index is loaded once and reused over the C
// channels. The in-row offsets are 32-bit; only the row base is 64-bit.
// When B % 4 != 0 or a pointer is not 16-byte aligned, the same kernel
// copies 4-byte words instead. The grid is a few waves over the SMs and
// strides over the rows.
#include "common.cuh"

namespace {

template <bool VEC>
__global__ void gather_rows_kernel(const uint32_t* __restrict__ x,
                                   const int* __restrict__ idx,
                                   uint32_t* __restrict__ out, int C,
                                   long long N, long long J, long long B,
                                   int W, int tpr_log2, uint32_t fill) {
  // W: words of a row (B / 4 16-byte words, or B 4-byte words)
  const int tpr = 1 << tpr_log2;
  const int sub = threadIdx.x & (tpr - 1);
  const long long row0 =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> tpr_log2;
  const long long rows = ((long long)gridDim.x * blockDim.x) >> tpr_log2;
  const long long in_cs = N * B;          // channel strides, in words of 4
  const long long out_cs = J * B;
  for (long long j = row0; j < J; j += rows) {
    const int src = __ldg(idx + j);
    uint32_t* o = out + j * B;
    const uint32_t* xr = x + (long long)(src < 0 ? 0 : src) * B;
    for (int w = sub; w < W; w += tpr) {
      const uint32_t* xc = xr;            // row (c, src) of x, row (c, j)
      uint32_t* oc = o;                   // of out: 64-bit bases
#pragma unroll 4
      for (int c = 0; c < C; ++c, xc += in_cs, oc += out_cs) {
        if (VEC) {
          const uint4 v = src >= 0
              ? __ldg(reinterpret_cast<const uint4*>(xc) + w)
              : make_uint4(fill, fill, fill, fill);
          reinterpret_cast<uint4*>(oc)[w] = v;
        } else {
          oc[w] = src >= 0 ? __ldg(xc + w) : fill;
        }
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

extern "C" int gather_rows(const void* x, const void* idx, void* out,
                           long long C, long long N, long long J,
                           long long B, unsigned int fill_bits,
                           void* stream) {
  if (C == 0 || J == 0 || B == 0) return 0;
  if (C > 0x7fffffffLL) return -1;
  const bool vec = B % 4 == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  const long long W = vec ? B / 4 : B;
  if (W > 0x7fffffffLL) return -1;
  int tpr_log2 = 0;                       // threads per row: W up to 32
  while ((1LL << tpr_log2) < W && tpr_log2 < 5) ++tpr_log2;
  const int threads = 256;
  const long long rows_per_block = threads >> tpr_log2;
  long long blocks = (J + rows_per_block - 1) / rows_per_block;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // a few waves: 4 x (the SMs x 8 resident blocks of 256 threads)
  const long long cap = 4LL * sms * (2048 / threads);
  if (blocks > cap) blocks = cap;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    gather_rows_kernel<true><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint32_t*)x, (const int*)idx, (uint32_t*)out, (int)C, N, J, B,
        (int)W, tpr_log2, (uint32_t)fill_bits);
  else
    gather_rows_kernel<false><<<(unsigned)blocks, threads, 0, st>>>(
        (const uint32_t*)x, (const int*)idx, (uint32_t*)out, (int)C, N, J, B,
        (int)W, tpr_log2, (uint32_t)fill_bits);
  return (int)cudaGetLastError();
}
