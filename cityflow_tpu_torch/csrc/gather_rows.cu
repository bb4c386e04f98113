// K1 gather_rows: out[c, j, b] = idx[j] >= 0 ? x[c, idx[j], b] : fill
// (static index), or with a per-(j, b) index for the dynamic selections.
//
// Replaces the one-hot operators of cityflow_tpu/core/ring.py: the lane <->
// in-lane exchanges and their shift plans (:300-341, :686-744), the typed
// one-hot einsums _typed_mm (:243-250) over E_start / E_end / E_rl / E_out /
// E_app, the to_link / from_link one-hot einsums (:1154-1168, :1441-1450),
// the E_el admission spread (:531-544) and the foe_perm / foe_gather
// exchange (:881-927). Each one-hot row holds at most one 1 (asserted when
// the index tables are built), so the einsum is exactly this gather.
//
// Bound: bytes. Every output element is one 4-byte read and one 4-byte
// write; the index is read once per (j, b). Threads run along b, the
// contiguous env axis, so a warp reads and writes 128 contiguous bytes.
#include "common.cuh"

__global__ void gather_rows_kernel(const uint32_t* __restrict__ x,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ didx,
                                   uint32_t* __restrict__ out, long long C,
                                   long long N, long long J, long long B,
                                   uint32_t fill) {
  long long total = C * J * B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % B;
    long long cj = e / B;
    long long j = cj % J;
    long long c = cj / J;
    int src = didx ? didx[j * B + b] : idx[j];
    out[e] = (src >= 0) ? x[(c * N + src) * B + b] : fill;
  }
}

extern "C" int gather_rows(const void* x, const void* idx, const void* didx,
                           void* out, long long C, long long N, long long J,
                           long long B, unsigned int fill_bits,
                           void* stream) {
  long long total = C * J * B;
  if (total == 0) return 0;
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  gather_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const int*)idx, (const int*)didx, (uint32_t*)out,
      C, N, J, B, (uint32_t)fill_bits);
  return (int)cudaGetLastError();
}
