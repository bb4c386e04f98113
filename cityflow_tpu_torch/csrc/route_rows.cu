// R4 route_rows: the route-table rows of this step's link -> lane
// transfers.
//
// Replaces the route compaction of cityflow_tpu/core/ring.py
// (:1567-1642). There the exits of each intersection's XKe * LPI candidate
// rows are sorted to the front with a multi-operand lax.sort (a sorting
// network; nonzero lowers to a slow scan on the TPU), compacted a second
// time to at most 1024 rows per env (a TPU gather budget), gathered from
// the route tables and scattered back through a TI-long where-chain. Here
// one thread owns one (intersection, env) column: it walks the candidate
// rows j = xs * LPI + l in order, counts the exits, and for the first TI
// of them reads route_next / route_aux at (route, rpos + 1, the end
// lane's local index) (and, under lane change, the MAXLPR entries at
// (route, rpos + 1)); every other row takes the fills. More than TI exits
// set OV_REMOVE. No second compaction: the rows past JAX's 1024 cap are
// looked up too (a pinned divergence of the port).
//
// pays[ch][xs][l * G + g][b]: nxt, nxt3 = (aux >> 1) - 2, last = aux & 1,
// then rn0.., ax0.. under lane change.
//
// Bound: bytes. The exit flags read, the payload rows written, and the
// exits' route and rpos read.
#include "ring_regions.cuh"

struct RouteRowsArgs {
  const uint8_t* exit_flags;  // (XKe, LPI * G, B)
  const int* k_route;         // (SK, LPI * G, B), rows < XKe read
  const int* k_rpos;
  const int* lk_end_lane;     // (LPI * G,)
  const int* ln_llocal;       // (LNp,)
  const int* route_next;      // (NR, RLEN, MAXLPR)
  const int* route_aux;
  int* pays;                  // (3 [+ 2 MAXLPR], XKe, LPI * G, B)
  int* ov;                    // (B,) OV_REMOVE bits
  long long XKe, LPI, G, B, LNp, NR, RLEN, MAXLPR, TI, lc;
};

#define OV_REMOVE 8

__device__ __forceinline__ long long clamp_rr(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void route_rows_kernel(const RouteRowsArgs a) {
  const long long LKp = a.LPI * a.G;
  const long long total = a.G * a.B;
  const long long slab = a.XKe * LKp * a.B;   // payload channel stride
  const long long FMAX = a.NR * a.RLEN * a.MAXLPR - 1;
  const long long nch = 3 + (a.lc ? 2 * a.MAXLPR : 0);
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t % a.B;
    const long long g = t / a.B;
    long long n_ex = 0;
    for (long long xs = 0; xs < a.XKe; ++xs) {
      for (long long l = 0; l < a.LPI; ++l) {
        const long long lk = l * a.G + g;
        const long long r = (xs * LKp + lk) * a.B + b;
        int* o = a.pays + r;
        const bool take = a.exit_flags[r] != 0 && n_ex < a.TI;
        n_ex += a.exit_flags[r] != 0;
        if (!take) {
          o[0] = -1;
          o[slab] = -1;
          o[2 * slab] = 0;
          for (long long c = 3; c < nch; ++c) o[c * slab] = -1;
          continue;
        }
        // the end lane's local index (jnp.take: INT_MIN past the end)
        const long long el = a.lk_end_lane[lk] > 0 ? a.lk_end_lane[lk] : 0;
        const long long ll = el < a.LNp ? (long long)a.ln_llocal[el]
                                        : (long long)(-2147483647 - 1);
        const long long rowb =
            (clamp_rr(a.k_route[r], 0, a.NR - 1) * a.RLEN +
             clamp_rr((long long)a.k_rpos[r] + 1, 0, a.RLEN - 1)) * a.MAXLPR;
        const long long gi =
            clamp_rr(rowb + clamp_rr(ll, 0, a.MAXLPR - 1), 0, FMAX);
        const int aux = a.route_aux[gi];
        o[0] = a.route_next[gi];
        o[slab] = (aux >> 1) - 2;
        o[2 * slab] = aux & 1;
        if (a.lc) {
          for (long long c = 0; c < a.MAXLPR; ++c) {
            const long long bi = clamp_rr(rowb + c, 0, FMAX);
            o[(3 + c) * slab] = a.route_next[bi];
            o[(3 + a.MAXLPR + c) * slab] = a.route_aux[bi];
          }
        }
      }
    }
    if (n_ex > a.TI) atomicOr(&a.ov[b], OV_REMOVE);
  }
}

extern "C" int route_rows(const RouteRowsArgs* args, void* stream) {
  const RouteRowsArgs a = *args;
  const long long total = a.G * a.B;
  if (total == 0 || a.XKe == 0) return 0;
  if (a.NR < 1 || a.RLEN < 1 || a.MAXLPR < 1) return -1;
  const int threads = 128;
  route_rows_kernel<<<rr::grid_for(total, threads), threads, 0,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
