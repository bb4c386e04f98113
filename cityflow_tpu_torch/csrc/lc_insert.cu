// L3 lc_insert: per target lane up to LCI shadow winners, the senders'
// change start, and the rank-preserving shadow inserts of every lane
// channel (reference LaneChange::insertShadow, lanechange.cpp:71-102;
// scheduleLaneChange, engine.cpp:792-820).
//
// Replaces the schedule part of lc_phase in cityflow_tpu/core/ring_lc.py
// (:369-531). The TPU version permutes the do_change / dir / dis channels
// and then the whole shadow bundle (20 + 2 * MAXLPR channels) to both
// neighbour columns (b_in / b_out), extracts each winner's bundle with an
// SL-long where-chain per channel, and inserts with a full-slab shift per
// winner and channel. Here:
//   lc_select_kernel  one thread per (target lane, env) scans the 2 * SL
//                     senders of its two neighbour columns and keeps up to
//                     LCI codes side * S + slot by distance descending (a
//                     tie keeps the first), and the overflow bit 1;
//   lc_insert_kernel  one thread per (lane, env) reads its winners' values
//                     from the source column by index, finds each insert
//                     rank on the original ring, and writes every output
//                     slot of every channel once: a winner's value, or the
//                     original row the inserts above it moved it from. Its
//                     own rows' started flags (a shadow of theirs got a
//                     slot in the target lane) come from the winner codes
//                     of its neighbour columns.
//
// Bound: bytes. Every channel of the lane ring is read and written once
// (about 90 bytes per slot with MAXLPR = 3), plus the neighbours' do_change /
// dir / dis for the selection.
#include "common.cuh"

#define MAX_CH 40
#define MAX_LCI 8
#define SHBIT (1 << 30)

enum { K_F32 = 0, K_I32 = 1, K_BOOL = 2 };
enum { W_SAME = 0, W_CONST = 1, W_NXT = 2, W_NXT3 = 3, W_PRI = 4, W_DIR = 5 };
enum { O_SRC = 0, O_CHG2 = 1, O_DIR2 = 2 };

struct InsChan {
  const void* src;  // (S, N, B) ring before the inserts (O_SRC)
  void* out;        // (S, N, B)
  int kind;
  int win;          // the winner's value: W_*
  int orig;         // the ring's own value: O_*
  float cval;       // W_CONST
};

struct LcInsertArgs {
  InsChan ch[MAX_CH];
  int nch;
  int* acc;                 // (LCI, N, B) winner codes, -1: none
  const uint8_t* do_change; // (S, N, B)
  const int* dirc;
  const uint8_t* sh;
  const uint8_t* chg;
  const int* dir;
  const float* dis;
  const int* n_l;           // (N, B)
  const int* uid;
  const int* rnrow;         // (M, S, N, B)
  const int* auxrow;
  const int* inner;         // (N,)
  const int* outer;
  const int* llocal;
  int* n_out;               // (N, B)
  uint8_t* ovl;             // (N, B) overflow bits
  long long S, N, B;
  int LCI, M;
};

__global__ void lc_select_kernel(const LcInsertArgs a) {
  long long total = a.N * a.B;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long p = e / a.B;
    int q[2] = {a.inner[p], a.outer[p]};
    int ncand = 0;
    for (int side = 0; side < 2; ++side) {
      if (q[side] < 0) continue;
      int want = side == 0 ? 1 : -1;
      for (long long t = 0; t < a.S; ++t) {
        long long f = (t * a.N + q[side]) * a.B + b;
        if (a.do_change[f] && a.dirc[f] == want) ++ncand;
      }
    }
    int acc[MAX_LCI];
    for (int j = 0; j < a.LCI; ++j) {
      float w_dis = -INFINITY;
      int w_code = -1;
      for (int side = 0; side < 2; ++side) {
        if (q[side] < 0) continue;
        int want = side == 0 ? 1 : -1;
        for (int t = 0; t < a.S; ++t) {
          int code = side * (int)a.S + t;
          bool used = false;
          for (int i = 0; i < j; ++i) used |= acc[i] == code;
          long long f = (t * a.N + q[side]) * a.B + b;
          if (a.do_change[f] && a.dirc[f] == want && !used &&
              a.dis[f] > w_dis) {
            w_dis = a.dis[f];
            w_code = code;
          }
        }
      }
      acc[j] = w_code;
      a.acc[j * total + e] = w_code;
    }
    a.ovl[e] = ncand > a.LCI ? 1 : 0;
  }
}

__global__ void lc_insert_kernel(const LcInsertArgs a) {
  long long total = a.N * a.B;
  long long SNB = a.S * total;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    long long b = e % a.B;
    long long p = e / a.B;
    int qi = a.inner[p], qo = a.outer[p];
    int n = a.n_l[e];
    // the winners into this lane: source row, insert rank, active
    long long wsrc[MAX_LCI];
    int wq[MAX_LCI], wt[MAX_LCI], wdir[MAX_LCI], pos[MAX_LCI];
    bool ex[MAX_LCI];
    int ncur = n;
    uint8_t ov = a.ovl[e];
    for (int j = 0; j < a.LCI; ++j) {
      int code = a.acc[j * total + e];
      ex[j] = code >= 0;
      int side = code >= 0 ? code / (int)a.S : 0;
      wt[j] = code >= 0 ? code % (int)a.S : 0;
      wq[j] = side == 0 ? qi : qo;
      wdir[j] = side == 0 ? 1 : -1;
      wsrc[j] = ex[j] ? (wt[j] * a.N + wq[j]) * a.B + b : -1;
      float wd = ex[j] ? a.dis[wsrc[j]] : 0.0f;
      int cnt = 0;
      for (long long t = 0; t < n; ++t)
        if (a.dis[t * total + e] >= wd) ++cnt;
      pos[j] = cnt + j;
      if (ex[j] && ncur >= a.S) ov |= 2;
      ex[j] = ex[j] && ncur < a.S;
      if (ex[j]) ++ncur;
    }
    a.n_out[e] = ncur;
    a.ovl[e] = ov;
    // winner codes of the neighbour columns (0 where there is none, as the
    // JAX permutation reads): my rows whose shadow got a slot there
    int acc_o[MAX_LCI], acc_i[MAX_LCI];
    for (int j = 0; j < a.LCI; ++j) {
      acc_o[j] = qo >= 0 ? a.acc[(j * a.N + qo) * a.B + b] : 0;
      acc_i[j] = qi >= 0 ? a.acc[(j * a.N + qi) * a.B + b] : 0;
    }
    for (int ci = 0; ci < a.nch; ++ci) {
      const InsChan& c = a.ch[ci];
      for (long long s = 0; s < a.S; ++s) {
        // undo the inserts, last first: the slot is winner j's, or comes
        // from the slot above it
        long long r = s;
        int hit = -1;
        for (int j = a.LCI - 1; j >= 0 && hit < 0; --j) {
          if (!ex[j]) continue;
          if (r == pos[j]) hit = j;
          else if (r > pos[j]) --r;
        }
        long long o = s * total + e;
        if (hit >= 0) {
          long long w = wsrc[hit];
          int lo = a.llocal[wq[hit]] + wdir[hit];
          bool in_m = lo >= 0 && lo < a.M;
          long long wr = ((lo * a.S + wt[hit]) * a.N + wq[hit]) * a.B + b;
          if (c.win == W_CONST) {
            if (c.kind == K_F32) ((float*)c.out)[o] = c.cval;
            else if (c.kind == K_I32) ((int*)c.out)[o] = (int)c.cval;
            else ((uint8_t*)c.out)[o] = c.cval > 0.5f;
          } else if (c.win == W_SAME) {
            if (c.kind == K_F32) ((float*)c.out)[o] = ((const float*)c.src)[w];
            else if (c.kind == K_I32) ((int*)c.out)[o] = ((const int*)c.src)[w];
            else ((uint8_t*)c.out)[o] = ((const uint8_t*)c.src)[w];
          } else if (c.win == W_NXT) {
            ((int*)c.out)[o] = in_m ? a.rnrow[wr] : -1;
          } else if (c.win == W_NXT3) {
            int aux = in_m ? a.auxrow[wr] : -1;
            ((int*)c.out)[o] = aux >= 0 ? (aux >> 1) - 2 : -1;
          } else if (c.win == W_PRI) {
            ((int*)c.out)[o] = SHBIT + a.uid[w];
          } else {
            ((int*)c.out)[o] = a.dirc[w];
          }
          continue;
        }
        long long i = r * total + e;
        if (c.orig == O_SRC) {
          if (c.kind == K_F32) ((float*)c.out)[o] = ((const float*)c.src)[i];
          else if (c.kind == K_I32) ((int*)c.out)[o] = ((const int*)c.src)[i];
          else ((uint8_t*)c.out)[o] = ((const uint8_t*)c.src)[i];
          continue;
        }
        // chg2 / dir2 of row r: started = do_change and a shadow of it got
        // a slot in its target lane
        int dc = a.dirc[i];
        int my_code = dc > 0 ? (int)r : (int)(a.S + r);
        bool ins = false;
        for (int j = 0; j < a.LCI; ++j)
          ins |= (dc > 0 ? acc_o[j] : acc_i[j]) == my_code;
        bool chg2 = a.chg[i] || (a.do_change[i] && ins);
        if (c.orig == O_CHG2) {
          ((uint8_t*)c.out)[o] = chg2;
        } else {
          ((int*)c.out)[o] = a.sh[i] ? a.dir[i] : (chg2 ? dc : 0);
        }
      }
    }
  }
}

extern "C" int lc_insert(const LcInsertArgs* args, void* stream) {
  long long total = args->N * args->B;
  if (total == 0) return 0;
  if (args->nch > MAX_CH || args->LCI > MAX_LCI) return -1;
  int threads = 128;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  lc_select_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  lc_insert_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
