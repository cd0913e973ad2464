// Mamba-2 SSD chunked scan, backward (K2b), for NVIDIA Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces what the JAX package gets from `jax.grad` through the model's
// `ssd_chunked` (src/repro/models/mamba2.py:42): the TPU kernel `_ssd_kernel`
// has no backward and the JAX models differentiate the jnp version.  Given
// x [B,S,H,P], dt [B,S,H], A [H], B, C [B,S,G,N], the initial state (or none)
// and dy [B,S,H,P] with the gradient of the final state (or none), it returns
// dx, ddt, dA, dB, dC and the gradient of the initial state.  The algebra is
// `ssd_chunked_bwd_ref` in ../ref.py, pass for pass.  For one chunk of Q rows,
// u_j = dt_j x_j, cum the in-order cumsum of dt A, h_c the state before the
// chunk, dh_{c+1} the gradient of the state after it and
// L_ij = exp(cum_i - cum_j) for i >= j (0 above):
//     du_j = sum_{i>=j} L_ij (C_i.B_j) dy_i + exp(cum_last - cum_j) dh B_j
//     dC_i = sum_{j<=i} L_ij (dy_i.u_j) B_j + exp(cum_i) dy_i h_c
//     dB_j = sum_{i>=j} L_ij (dy_i.u_j) C_i + exp(cum_last - cum_j) u_j dh
//     dh_c = exp(cum_last) dh_{c+1} + sum_i exp(cum_i) dy_i (x) C_i
// and the gradient of every cum that a term reads, whose reverse in-chunk
// cumsum is the gradient of dt A.
//
// What bounds it on this card.  At mamba2-1.3b's training shape (x
// [8,1024,64,64] bf16, N 128, chunk 256) the inputs and outputs are some
// 214 MB (0.064 ms at 3.35 TB/s) against some 61 GFLOP of products that the
// algebra needs at the least (0.062 ms at the bf16 tensor-core peak: C.B^T,
// and dB and dC on the sum over a group's heads of L o (dy.u^T), once a
// group): bytes bound it, narrowly.  Both variants take dB and dC per head
// (95 GFLOP there), which lets a block own its heads' sums.  Two variants; the wrapper's
// `kernel.variant_bwd()` chooses by (dtype, P, N, chunk) and passes its code:
//  * `ssd_bwd_wgmma`, bf16 at P 64, N 64 or 128, chunk 64, 128 or 256 (the
//    forward's `ssd_wgmma` domain: the training paths of mamba2-1.3b, N 128,
//    and zamba2-1.2b, N 64), three kernels on wgmma + TMA (the section that
//    holds them says how), then `ssd_bwd_dt` and `ssd_bwd_reduce` below.
//  * `ssd_bwd_simt`, every other input and every fp32 one (which must hold
//    the plain version to 1e-4): five kernels on the fp32 pipes, 4 x 4
//    register tiles a thread, one after the other on the stream:
//  1. `ssd_bwd_chunk_state`, one block per (batch, chunk, head): cum (written
//     for the later passes), the chunk's term of the state recurrence
//     sum_j exp(cum_last - cum_j) u_j (x) B_j and of the reverse one
//     sum_i exp(cum_i) dy_i (x) C_i, [P, N] each, into fp32 scratch.
//  2. `ssd_bwd_state_scan`, one block per (batch, head): the forward
//     recurrence in fp32 over the chunks, writing h_c over the first term,
//     then the reverse one, writing dh_{c+1} over the second, the gradient
//     of the initial state, and exp(cum_last) <h_c, dh_{c+1}> per chunk.
//     h_c is recomputed: the forward's wgmma path keeps it only in bf16.
//  3. `ssd_bwd_chunk_grads`, one block per (batch, chunk, row tile of 64,
//     tile of up to 8 heads of one group): for each head, the row tile as
//     the columns j of the pairs below it (du, dB, the cum_j terms) and as
//     the rows i of the pairs left of it (dC, the cum_i terms), then the
//     terms from the states at the chunk's two ends.  dB and dC of the heads
//     of the tile are summed in registers; dx and x.du are written.
//  4. `ssd_bwd_dt`, one thread per (batch, chunk, head, 8 rows): the reverse
//     cumsum of the cum gradients, ddt and the chunk's part of dA.
//  5. `ssd_bwd_reduce`: dB and dC summed over the head tiles of a group (in a
//     fixed order) and cast to the inputs' type; dA summed over batch and
//     chunks.
//    It computes some 150 GFLOP at the training shape on the fp32 pipes (67
//    TFLOP/s at best): the pair products (C.B^T and dy.u^T for each pair of
//    64-row tiles) twice, once for the column role and once for the row
//    role, so that no block needs another's sums.  The fp32 scratch of pass
//    2 is two [B, nc, H, P, N] arrays (67 MB each there).
// No variant uses atomics: every sum has one order, so two calls give equal
// bits.
//
// dA = sum_m dcum_m cum_m / A is taken term by term (each pair's dS_ij with
// cum_i - cum_j, each s_j with cum_last - cum_j), never as dcum_m cum_m: cum
// reaches some -200 within a chunk of 256, and that product would multiply
// the rounding of dcum's cancelling sums by as much.
//
// What the design changes against the plain version.  The [Q, Q] matrices
// are never formed: they are tiled like causal attention, 64 x 64, pairs at
// or below the diagonal only; the decay exp(cum_i - cum_j) is taken only
// where j <= i (above the diagonal it overflows).  Groups are an index,
// g = h / (H / G), not a repeat of B and C.  Rows past S load as 0 with
// dt = 0, as the forward pads them, and are never written.
//
// The C interface at the end returns cudaGetLastError() of the launches (or
// cudaErrorInvalidValue when the driver refuses a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper_mma.cuh"
#include "../../csrc/hopper_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kStateRows = 32;   // row tile of pass 1
constexpr int kMaxHeads = 8;     // heads a block of pass 3 serves
constexpr int kScanRegs = kMaxP * kMaxN / kThreads;  // state elements a thread

// The launches of each CUDA kernel since the library was loaded, counted at
// the launch itself once it succeeded (read through ssd_bwd_kernel_launches).
enum SsdBwdKernel {
  kChunkState, kStateScan, kChunkGrads, kDt, kReduce,
  kStatesWgmma, kDxdbWgmma, kDcWgmma, kNumKernels
};
const char* const kKernelNames[kNumKernels] = {
    "ssd_bwd_chunk_state", "ssd_bwd_state_scan", "ssd_bwd_chunk_grads",
    "ssd_bwd_dt", "ssd_bwd_reduce", "ssd_bwd_states_wgmma",
    "ssd_bwd_dxdb_wgmma", "ssd_bwd_dc_wgmma"};
long long g_launches[kNumKernels] = {};

cudaError_t counted(cudaError_t e, SsdBwdKernel kernel) {
  if (e == cudaSuccess) ++g_launches[kernel];
  return e;
}

// The codes of kernel.VARIANT_CODES_BWD (a test holds the two to each other);
// the wrapper's variant_bwd() chooses.
enum SsdBwdVariant {
  kBwdFp32Pipes = 0,  // ssd_bwd_simt
  kBwdWgmma = 1,      // ssd_bwd_wgmma
};

struct BwdParams {
  const void* x;      // [B, S, H, P], fp32 or bf16
  const float* dt;    // [B, S, H]
  const float* A;     // [H]
  const void* b;      // [B, S, G, N], the type of x
  const void* c;      // [B, S, G, N]
  const float* h0;    // [B, H, P, N], or null for a zero state
  const void* dy;     // [B, S, H, P], the type of x
  const float* dhT;   // [B, H, P, N], or null for a zero gradient
  void* dx;           // [B, S, H, P], the type of x
  float* ddt;         // [B, S, H]
  float* dA;          // [H]
  void* db;           // [B, S, G, N], the type of x
  void* dc;
  float* dh0;         // [B, H, P, N]
  // fp32 scratch, carved out of one buffer by carve()
  float* cum;         // [B, nc, H, cum_ld]: cum (ssd_bwd_wgmma: then dt)
  float* st;          // [B, nc, H, P, N]: chunk state term, then h_c
  float* dst;         // [B, nc, H, P, N]: chunk term of dh, then dh_{c+1}
                      // (ssd_bwd_wgmma: both in bf16, h_c and dh_{c+1} only)
  float* hdh;         // [B, nc, H]: exp(cum_last) <h_c, dh_{c+1}>
  float* rdcum;       // [B, S, H]: the cum gradient of the pairs and y_inter
  float* rs;          // [B, S, H]: s_j = u_j . du_inter_j
  void* hb;           // ssd_bwd_wgmma: h_c [B, nc, H, P, N] bf16 (in st's place)
  void* dhb;          // ssd_bwd_wgmma: dh_{c+1} (in dst's place)
  float* da_tile;     // [B, nc, H, Q / 64 or 1]: a row tile's part of A dA
  float* dA_part;     // [B, nc, H]: a chunk's A dA
  float* db_part;     // [B, S, H / heads, N]
  float* dc_part;
  int batch, S, H, G, P, N, Q, nc, heads;
  int cum_ld;         // floats from one (b, chunk, head)'s cum to the next
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Rows [row0, row0 + rows) of a chunk-local [., cols] slab of type Tin with
// row stride `ld_g` into fp32 shared memory with row stride `ld_s`; rows at
// or beyond `valid` are zero.
template <typename Tin>
__device__ __forceinline__ void load_rows(float* dst, int ld_s, const Tin* src,
                                          long long ld_g, int row0, int rows,
                                          int valid, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, col = i % cols;
    const int row = row0 + r;
    dst[r * ld_s + col] = row < valid ? to_f32(src[row * ld_g + col]) : 0.f;
  }
}

// A [P, N] state of fp32 scratch into shared memory with row stride ld_s.
__device__ __forceinline__ void load_state(float* dst, int ld_s, const float* src,
                                           int P, int N) {
  for (int i = threadIdx.x; i < P * N; i += kThreads)
    dst[(i / N) * ld_s + i % N] = src[i];
}

// ---------------------------------------------------------------------------
// 1. cum and the chunk's terms of the two recurrences
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ size_t state_smem_bytes(int P, int N) {
  return sizeof(float) * (3 * kMaxChunk + 2 * kStateRows * (P + 1) +
                          2 * kStateRows * (N + 1));
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_state(BwdParams p) {
  const int h = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P, N = p.N, Q = p.Q;
  const int g = h / (H / p.G);
  const int tid = threadIdx.x;
  const int LDP = P + 1, LDN = N + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [Q]
  float* wts = cum + kMaxChunk;                     // [Q] dt exp(cum_last - cum)
  float* ecum = wts + kMaxChunk;                    // [Q] exp(cum)
  float* Xs = ecum + kMaxChunk;                     // [32][LDP] x
  float* Ys = Xs + kStateRows * LDP;                // [32][LDP] dy
  float* Bs = Ys + kStateRows * LDP;                // [32][LDN] B
  float* Cs = Bs + kStateRows * LDN;                // [32][LDN] C

  const int c0 = ci * Q, rows = min(Q, S - c0);
  const long long ld_x = (long long)H * P, ld_bc = (long long)p.G * N;
  const long long xo = ((long long)b * S + c0) * H * P + (long long)h * P;
  const long long bo = ((long long)b * S + c0) * p.G * N + (long long)g * N;
  const Tin* xg = static_cast<const Tin*>(p.x) + xo;
  const Tin* yg = static_cast<const Tin*>(p.dy) + xo;
  const Tin* bg = static_cast<const Tin*>(p.b) + bo;
  const Tin* cg = static_cast<const Tin*>(p.c) + bo;
  const float* dtg = p.dt + ((long long)b * S + c0) * H + h;
  const long long bch = ((long long)b * p.nc + ci) * H + h;

  // dt (0 past S) and cum = cumsum(dt A), in order by one thread as the
  // forward takes it
  if (tid < Q) wts[tid] = tid < rows ? dtg[(long long)tid * H] : 0.f;
  __syncthreads();
  if (tid == 0) {
    const float a = p.A[h];
    float v = 0.f;
    for (int i = 0; i < Q; ++i) {
      v += wts[i] * a;
      cum[i] = v;
    }
  }
  __syncthreads();
  const float cum_last = cum[Q - 1];
  if (tid < Q) {
    p.cum[bch * Q + tid] = cum[tid];
    wts[tid] *= expf(cum_last - cum[tid]);
    ecum[tid] = expf(cum[tid]);
  }

  // thread tiles of [P, N]: 4 rows x 4 interleaved columns, up to two a thread
  const int hcols = N / 4, n_tiles = (P / 4) * hcols;
  float acc_s[2][4][4], acc_d[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_s[s][i][j] = acc_d[s][i][j] = 0.f;

  for (int k0 = 0; k0 < rows; k0 += kStateRows) {
    __syncthreads();  // the tiles are free; wts and ecum are set
    load_rows<Tin>(Xs, LDP, xg, ld_x, k0, kStateRows, rows, P);
    load_rows<Tin>(Ys, LDP, yg, ld_x, k0, kStateRows, rows, P);
    load_rows<Tin>(Bs, LDN, bg, ld_bc, k0, kStateRows, rows, N);
    load_rows<Tin>(Cs, LDN, cg, ld_bc, k0, kStateRows, rows, N);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int t = tid + s * kThreads;
      if (t >= n_tiles) continue;
      const int hm = t / hcols, hn = t % hcols;
      for (int j = 0; j < kStateRows; ++j) {
        const float w = wts[k0 + j], e = ecum[k0 + j];
        float xv[4], yv[4], bv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = Xs[j * LDP + hm * 4 + i] * w;
          yv[i] = Ys[j * LDP + hm * 4 + i] * e;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          bv[jj] = Bs[j * LDN + hn + jj * hcols];
          cv[jj] = Cs[j * LDN + hn + jj * hcols];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc_s[s][i][jj] = fmaf(xv[i], bv[jj], acc_s[s][i][jj]);
            acc_d[s][i][jj] = fmaf(yv[i], cv[jj], acc_d[s][i][jj]);
          }
      }
    }
  }

  float* st = p.st + bch * P * N;
  float* dst = p.dst + bch * P * N;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = tid + s * kThreads;
    if (t >= n_tiles) continue;
    const int hm = t / hcols, hn = t % hcols;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int e = (hm * 4 + i) * N + hn + jj * hcols;
        st[e] = acc_s[s][i][jj];
        dst[e] = acc_d[s][i][jj];
      }
  }
}

// ---------------------------------------------------------------------------
// 2. the two recurrences over the chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) ssd_bwd_state_scan(BwdParams p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int H = p.H, PN = p.P * p.N, Q = p.Q, nc = p.nc;
  const int tid = threadIdx.x;
  __shared__ float warp_sums[kThreads / 32];
  const long long bh = ((long long)b * H + h) * PN;
  float hr[kScanRegs], dr[kScanRegs];
#pragma unroll
  for (int k = 0; k < kScanRegs; ++k) {
    const int e = tid + k * kThreads;
    hr[k] = (e < PN && p.h0) ? p.h0[bh + e] : 0.f;
    dr[k] = (e < PN && p.dhT) ? p.dhT[bh + e] : 0.f;
  }
  // forward: h_c over the chunk's term, h <- h exp(cum_last) + term
  for (int ci = 0; ci < nc; ++ci) {
    const long long bch = ((long long)b * nc + ci) * H + h;
    const float decay = expf(p.cum[bch * Q + Q - 1]);
    float* st = p.st + bch * PN;
#pragma unroll
    for (int k = 0; k < kScanRegs; ++k) {
      const int e = tid + k * kThreads;
      if (e >= PN) continue;
      const float term = st[e];
      st[e] = hr[k];
      hr[k] = hr[k] * decay + term;
    }
  }
  // reverse: dh_{c+1} over the chunk's term, exp(cum_last) <h_c, dh_{c+1}>,
  // dh <- dh exp(cum_last) + term
  for (int ci = nc - 1; ci >= 0; --ci) {
    const long long bch = ((long long)b * nc + ci) * H + h;
    const float decay = expf(p.cum[bch * Q + Q - 1]);
    const float* st = p.st + bch * PN;
    float* dst = p.dst + bch * PN;
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < kScanRegs; ++k) {
      const int e = tid + k * kThreads;
      if (e >= PN) continue;
      const float term = dst[e];
      dst[e] = dr[k];
      dot = fmaf(st[e], dr[k], dot);
      dr[k] = dr[k] * decay + term;
    }
    // the block's sum in a fixed order: a tree within each warp, then the
    // warps in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    __syncthreads();  // the previous chunk's sums are read
    if ((tid & 31) == 0) warp_sums[tid >> 5] = dot;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
      p.hdh[bch] = decay * total;
    }
  }
#pragma unroll
  for (int k = 0; k < kScanRegs; ++k) {
    const int e = tid + k * kThreads;
    if (e < PN) p.dh0[bh + e] = dr[k];
  }
}

// ---------------------------------------------------------------------------
// 3. the chunk gradients
// ---------------------------------------------------------------------------

// Shared memory of pass 3 in floats, for row tiles of T and the largest P
// and N: cum and dt of the chunk; the fixed tiles F1 [T][N+1] and F2
// [T][P+1]; the moving tiles V1 [64][N+1] (also a [P, N] state) and V2
// [T][P+1]; M and G [T][T+1]; partial sums [32][T]; five per-row arrays.
__host__ __device__ __forceinline__ int grads_smem_floats(int T, int P, int N) {
  return 2 * kMaxChunk + T * (N + 1) + T * (P + 1) + kMaxP * (N + 1) +
         T * (P + 1) + 2 * T * (T + 1) + 32 * T + 5 * T;
}

// One [T, T] pair tile, this thread's 4 x 4 entries: rows i of the tile at
// chunk row ia0 (operands r1 [.][ld1], r2 [.][ld2]) against columns j of the
// tile at chunk row jb0 (c1, c2): m = L o (r1 . c1 over K1 columns), the C.B^T
// part; g = L o (r2 . c2 over K2 columns) dt_j, the dy.u^T part; ds = m o
// (r2 . c2) dt_j; and `da` += ds_ij (cum_i - cum_j), the pairs' part of A dA.
template <int T>
__device__ __forceinline__ void pair_tile(
    const float* r1, const float* c1, int ld1, int K1,
    const float* r2, const float* c2, int ld2, int K2,
    int sm, int sn, int ia0, int jb0, const float* cum, const float* dts,
    float (&m)[4][4], float (&g)[4][4], float (&ds)[4][4], float& da) {
  constexpr int q = T / 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) m[a][bb] = g[a][bb] = 0.f;
  for (int k = 0; k < K1; ++k) {
    float rv[4], cv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) rv[a] = r1[(sm * 4 + a) * ld1 + k];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) cv[bb] = c1[(sn + bb * q) * ld1 + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) m[a][bb] = fmaf(rv[a], cv[bb], m[a][bb]);
  }
  for (int k = 0; k < K2; ++k) {
    float rv[4], cv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) rv[a] = r2[(sm * 4 + a) * ld2 + k];
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) cv[bb] = c2[(sn + bb * q) * ld2 + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) g[a][bb] = fmaf(rv[a], cv[bb], g[a][bb]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = ia0 + sm * 4 + a;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      const int qj = jb0 + sn + bb * q;
      // mask first: exp(cum_i - cum_j) overflows above the diagonal
      const float diff = cum[qi] - cum[qj];
      const float L = qj <= qi ? expf(diff) : 0.f;
      const float yu = g[a][bb] * dts[qj];  // dy_i . u_j
      m[a][bb] *= L;                          // L o (C B^T)
      g[a][bb] = L * yu;                      // L o (dy u^T)
      ds[a][bb] = m[a][bb] * yu;
      if (qj <= qi) da = fmaf(ds[a][bb], diff, da);
    }
  }
}

template <typename Tin, int T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_grads(BwdParams p) {
  constexpr int q = T / 4;
  const int nt = p.Q / T;
  const int tt = blockIdx.x % nt, ht = blockIdx.x / nt;
  const int ci = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P, N = p.N, Q = p.Q, G = p.G;
  const int heads = p.heads, h_first = ht * heads, g = h_first / (H / G);
  const int tid = threadIdx.x;
  const int c0 = ci * Q, rows = min(Q, S - c0);
  const int n_valid = (rows + T - 1) / T;  // row tiles that hold a valid row
  if (tt >= n_valid) return;
  const int t0 = tt * T;
  const int LDP = P + 1, LDN = N + 1, LDT = T + 1;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [Q]
  float* dts = cum + kMaxChunk;                     // [Q] dt, 0 past S
  float* F1 = dts + kMaxChunk;                      // [T][LDN] B_T, then C_T
  float* F2 = F1 + T * LDN;                         // [T][LDP] x_T, then dy_T
  float* V1 = F2 + T * LDP;                         // [64][LDN] C_I, B_J, dh, h
  float* V2 = V1 + kMaxP * LDN;                     // [T][LDP] dy_I, x_J
  float* Ms = V2 + T * LDP;                         // [T][LDT]
  float* Gs = Ms + T * LDT;                         // [T][LDT]
  float* red = Gs + T * LDT;                        // [32][T] partial sums
  float* dcum_col = red + 32 * T;                   // [T] per row of the tile
  float* dcum_row = dcum_col + T;
  float* sterm = dcum_row + T;
  float* yterm = sterm + T;
  float* xdu = yterm + T;

  const long long ld_x = (long long)H * P, ld_bc = (long long)G * N;
  const long long row_x = ((long long)b * S + c0) * H * P;
  const Tin* bg = static_cast<const Tin*>(p.b) + ((long long)b * S + c0) * G * N + (long long)g * N;
  const Tin* cg = static_cast<const Tin*>(p.c) + ((long long)b * S + c0) * G * N + (long long)g * N;

  // thread tiles: pairs [T, T] (sm, sn); [T, P] (pm, pn); [T, N] up to two
  // (nm, nn) a thread; 4 rows x 4 interleaved columns each
  const bool pair_owner = tid < q * q;
  const int sm = tid / q, sn = tid % q;
  const int pq = P / 4;
  const bool p_owner = tid < q * pq;
  const int pm = tid / pq, pn = tid % pq;
  const int nq = N / 4, n_ntiles = q * nq;

  float dB[2][4][4], dC[2][4][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dB[s][i][j] = dC[s][i][j] = 0.f;

  for (int h = h_first; h < h_first + heads; ++h) {
    const long long bch = ((long long)b * p.nc + ci) * H + h;
    const Tin* xg = static_cast<const Tin*>(p.x) + row_x + (long long)h * P;
    const Tin* yg = static_cast<const Tin*>(p.dy) + row_x + (long long)h * P;
    const float* dtg = p.dt + ((long long)b * S + c0) * H + h;
    __syncthreads();  // the previous head no longer reads anything
    if (tid < Q) {
      cum[tid] = p.cum[bch * Q + tid];
      dts[tid] = tid < rows ? dtg[(long long)tid * H] : 0.f;
    }
    if (tid < T) dcum_col[tid] = dcum_row[tid] = 0.f;
    // -- the tile as columns j: pairs (I, T) for I = tt.. (du, dB, -dS) --
    load_rows<Tin>(F1, LDN, bg, ld_bc, t0, T, rows, N);
    load_rows<Tin>(F2, LDP, xg, ld_x, t0, T, rows, P);
    float du[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) du[a][bb] = 0.f;
    for (int it = tt; it < n_valid; ++it) {
      const int i0 = it * T;
      __syncthreads();  // V1, V2, Ms, Gs and red are free
      load_rows<Tin>(V1, LDN, cg, ld_bc, i0, T, rows, N);
      load_rows<Tin>(V2, LDP, yg, ld_x, i0, T, rows, P);
      __syncthreads();
      if (pair_owner) {
        float m[4][4], gg[4][4], ds[4][4], unused = 0.f;
        pair_tile<T>(V1, F1, LDN, N, V2, F2, LDP, P, sm, sn, i0, t0, cum, dts,
                     m, gg, ds, unused);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float col = 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            Ms[(sm * 4 + a) * LDT + sn + bb * q] = m[a][bb];
            Gs[(sm * 4 + a) * LDT + sn + bb * q] = gg[a][bb];
            col += ds[a][bb];
          }
          red[sm * T + sn + bb * q] = col;
        }
      }
      __syncthreads();
      if (tid < T) {
        float col = 0.f;
        for (int k = 0; k < q; ++k) col += red[k * T + tid];
        dcum_col[tid] -= col;
      }
      // du_j += sum_i M_ij dy_i; dB_j += sum_i G_ij C_i
      if (p_owner) {
        for (int i = 0; i < T; ++i) {
          float mv[4], yv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) mv[a] = Ms[i * LDT + pm * 4 + a];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) yv[bb] = V2[i * LDP + pn + bb * pq];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) du[a][bb] = fmaf(mv[a], yv[bb], du[a][bb]);
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int t = tid + s * kThreads;
        if (t >= n_ntiles) continue;
        const int nm = t / nq, nn = t % nq;
        for (int i = 0; i < T; ++i) {
          float gv[4], cv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = Gs[i * LDT + nm * 4 + a];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) cv[bb] = V1[i * LDN + nn + bb * nq];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) dB[s][a][bb] = fmaf(gv[a], cv[bb], dB[s][a][bb]);
        }
      }
    }
    // -- from the state after the chunk: dh_{c+1} [P, N] into V1 --
    __syncthreads();
    load_state(V1, LDN, p.dst + bch * P * N, P, N);
    __syncthreads();
    const float cum_last = cum[Q - 1];
    if (p_owner) {
      // du_inter_j = exp(cum_last - cum_j) dh B_j; s_j = u_j . du_inter_j
      float di[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) di[a][bb] = 0.f;
      for (int k = 0; k < N; ++k) {
        float bv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = F1[(pm * 4 + a) * LDN + k];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) hv[bb] = V1[(pn + bb * pq) * LDN + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) di[a][bb] = fmaf(bv[a], hv[bb], di[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = pm * 4 + a;
        const float w = expf(cum_last - cum[t0 + j]);
        float sj = 0.f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          di[a][bb] *= w;
          sj = fmaf(F2[j * LDP + pn + bb * pq], di[a][bb], sj);
          du[a][bb] += di[a][bb];
        }
        red[pn * T + j] = sj * dts[t0 + j];
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // dB_j += exp(cum_last - cum_j) u_j dh
      const int t = tid + s * kThreads;
      if (t >= n_ntiles) continue;
      const int nm = t / nq, nn = t % nq;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
      for (int k = 0; k < P; ++k) {
        float xv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = F2[(nm * 4 + a) * LDP + k];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) hv[bb] = V1[k * LDN + nn + bb * nq];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(xv[a], hv[bb], acc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = nm * 4 + a;
        const float w = expf(cum_last - cum[t0 + j]) * dts[t0 + j];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) dB[s][a][bb] = fmaf(acc[a][bb], w, dB[s][a][bb]);
      }
    }
    __syncthreads();
    if (tid < T) {
      float sj = 0.f;
      for (int k = 0; k < pq; ++k) sj += red[k * T + tid];
      sterm[tid] = sj;
    }
    __syncthreads();  // red is read
    // dx_j = dt_j du_j, and x_j . du_j for ddt
    if (p_owner) {
      Tin* dxg = static_cast<Tin*>(p.dx) + row_x + (long long)h * P;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = pm * 4 + a, row = t0 + j;
        float xd = 0.f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          xd = fmaf(F2[j * LDP + pn + bb * pq], du[a][bb], xd);
          if (row < rows) store_out(dxg + row * ld_x + pn + bb * pq, du[a][bb] * dts[row]);
        }
        red[pn * T + j] = xd;
      }
    }
    __syncthreads();
    if (tid < T) {
      float xd = 0.f;
      for (int k = 0; k < pq; ++k) xd += red[k * T + tid];
      xdu[tid] = xd;
    }
    // -- the tile as rows i: pairs (T, J) for J = 0..tt (dC, +dS) --
    float da = 0.f;   // this thread's pairs' part of A dA
    __syncthreads();  // F1, F2 and red are free
    load_rows<Tin>(F1, LDN, cg, ld_bc, t0, T, rows, N);
    load_rows<Tin>(F2, LDP, yg, ld_x, t0, T, rows, P);
    for (int jt = 0; jt <= tt; ++jt) {
      const int j0 = jt * T;
      __syncthreads();
      load_rows<Tin>(V1, LDN, bg, ld_bc, j0, T, rows, N);
      load_rows<Tin>(V2, LDP, xg, ld_x, j0, T, rows, P);
      __syncthreads();
      if (pair_owner) {
        float m[4][4], gg[4][4], ds[4][4];
        pair_tile<T>(F1, V1, LDN, N, F2, V2, LDP, P, sm, sn, t0, j0, cum, dts,
                     m, gg, ds, da);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float row = 0.f;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            Gs[(sm * 4 + a) * LDT + sn + bb * q] = gg[a][bb];
            row += ds[a][bb];
          }
          red[sn * T + sm * 4 + a] = row;
        }
      }
      __syncthreads();
      if (tid < T) {
        float row = 0.f;
        for (int k = 0; k < q; ++k) row += red[k * T + tid];
        dcum_row[tid] += row;
      }
      // dC_i += sum_j G_ij B_j
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int t = tid + s * kThreads;
        if (t >= n_ntiles) continue;
        const int nm = t / nq, nn = t % nq;
        for (int j = 0; j < T; ++j) {
          float gv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = Gs[(nm * 4 + a) * LDT + j];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) bv[bb] = V1[j * LDN + nn + bb * nq];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) dC[s][a][bb] = fmaf(gv[a], bv[bb], dC[s][a][bb]);
        }
      }
    }
    // -- from the state before the chunk: h_c [P, N] into V1 --
    __syncthreads();
    load_state(V1, LDN, p.st + bch * P * N, P, N);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      // dC_inter_i = exp(cum_i) dy_i h_c; dy_i . y_inter_i = C_i . dC_inter_i
      const int t = tid + s * kThreads;
      if (t >= n_ntiles) continue;
      const int nm = t / nq, nn = t % nq;
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) acc[a][bb] = 0.f;
      for (int k = 0; k < P; ++k) {
        float yv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) yv[a] = F2[(nm * 4 + a) * LDP + k];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) hv[bb] = V1[k * LDN + nn + bb * nq];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) acc[a][bb] = fmaf(yv[a], hv[bb], acc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = nm * 4 + a;
        const float e = expf(cum[t0 + i]);
        float yi = 0.f;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float v = acc[a][bb] * e;
          yi = fmaf(F1[i * LDN + nn + bb * nq], v, yi);
          dC[s][a][bb] += v;
        }
        red[nn * T + i] = yi;
      }
    }
    __syncthreads();
    if (tid < T) {
      float yi = 0.f;
      for (int k = 0; k < nq; ++k) yi += red[k * T + tid];
      yterm[tid] = yi;
      const int row = t0 + tid;
      if (row < rows) {
        const long long o = ((long long)b * S + c0 + row) * H + h;
        p.rdcum[o] = dcum_row[tid] + dcum_col[tid] + yterm[tid];
        p.rs[o] = sterm[tid];
        p.ddt[o] = xdu[tid];
      }
    }
    // the tile's part of A dA, term by term (the note at the top): the
    // pairs' dS_ij (cum_i - cum_j), s_j (cum_last - cum_j) and
    // (dy_i . y_inter_i) cum_i
    __syncthreads();  // red and yterm are read and written
    red[tid] = da;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int k = 0; k < kThreads; ++k) v += red[k];
      for (int i = 0; i < T && t0 + i < rows; ++i)
        v += sterm[i] * (cum_last - cum[t0 + i]) + yterm[i] * cum[t0 + i];
      p.da_tile[bch * nt + tt] = v;
    }
  }

  // dB and dC of the tile's heads, summed, into the partials of pass 5
  const int n_ht = H / heads;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int t = tid + s * kThreads;
    if (t >= n_ntiles) continue;
    const int nm = t / nq, nn = t % nq;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = t0 + nm * 4 + a;
      if (row >= rows) continue;
      const long long o = (((long long)b * S + c0 + row) * n_ht + ht) * N;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        p.db_part[o + nn + bb * nq] = dB[s][a][bb];
        p.dc_part[o + nn + bb * nq] = dC[s][a][bb];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. ddt and dA from the reverse in-chunk cumsum of the cum gradients
// ---------------------------------------------------------------------------


// One block per (batch, chunk, 32 heads), one thread per (head, segment of
// kDtRows rows): the segments' sums meet in shared memory, and each thread
// starts its segment's reverse cumsum from the sums of the segments after it,
// added in one order (two calls give equal bits).  Neighbouring threads take
// neighbouring heads, so each warp reads 128 contiguous bytes a row.
constexpr int kDtRows = 8;

__global__ void __launch_bounds__(1024) ssd_bwd_dt(BwdParams p) {
  __shared__ float seg_s[kMaxChunk / kDtRows][32], seg_d[kMaxChunk / kDtRows][32];
  const int H = p.H, Q = p.Q, S = p.S;
  const int hl = threadIdx.x % 32, sg = threadIdx.x / 32, n_seg = Q / kDtRows;
  const int h = blockIdx.x * 32 + hl, ci = blockIdx.y, b = blockIdx.z;
  const int c0 = ci * Q, rows = min(Q, S - c0);
  const int k0 = sg * kDtRows, k1 = min(k0 + kDtRows, rows);
  const long long o = ((long long)b * S + c0) * H + h;  // the chunk's first row
  // s_j moves cum_j down and cum_last up: after the reverse cumsum, row k
  // holds the s of the rows before it
  float sum_s = 0.f, sum_d = 0.f;
  if (h < H) {
    for (int k = k0; k < k1; ++k) {
      const float sv = p.rs[o + (long long)k * H];
      sum_s += sv;
      sum_d += p.rdcum[o + (long long)k * H] - sv;
    }
  }
  seg_s[sg][hl] = sum_s;
  seg_d[sg][hl] = sum_d;
  __syncthreads();
  if (h >= H) return;
  const long long idx = ((long long)b * p.nc + ci) * H + h;
  float total_s = 0.f;
  for (int g = 0; g < n_seg; ++g) total_s += seg_s[g][hl];
  float acc = p.hdh[idx] + total_s;
  for (int g = n_seg - 1; g > sg; --g) acc += seg_d[g][hl];
  const float a = p.A[h];
  for (int k = k1 - 1; k >= k0; --k) {
    const long long r = o + (long long)k * H;
    acc += p.rdcum[r] - p.rs[r];
    p.ddt[r] += a * acc;
  }
  if (sg != 0) return;
  // A dA of the chunk: its row tiles' parts and <h_c, dh_{c+1}>'s
  const int T = Q >= 64 ? 64 : 32, nt = Q / T, n_valid = (rows + T - 1) / T;
  float v = 0.f;
  for (int t = 0; t < n_valid; ++t) v += p.da_tile[idx * nt + t];
  p.dA_part[idx] = v + p.hdh[idx] * p.cum[idx * p.cum_ld + Q - 1];
}

// ---------------------------------------------------------------------------
// 5. dB and dC over the head tiles of each group; dA over batch and chunks
// ---------------------------------------------------------------------------

template <typename Tout>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(BwdParams p) {
  const long long n_el = (long long)p.batch * p.S * p.G * p.N;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int n_ht = p.H / p.heads, per_group = n_ht / p.G;
  if (idx < n_el) {
    const int n = static_cast<int>(idx % p.N);
    const long long bsg = idx / p.N;
    const int g = static_cast<int>(bsg % p.G);
    const long long bs = bsg / p.G;
    const long long base = (bs * n_ht + (long long)g * per_group) * p.N + n;
    float vb = 0.f, vc = 0.f;
    for (int k = 0; k < per_group; ++k) {
      vb += p.db_part[base + (long long)k * p.N];
      vc += p.dc_part[base + (long long)k * p.N];
    }
    store_out(static_cast<Tout*>(p.db) + idx, vb);
    store_out(static_cast<Tout*>(p.dc) + idx, vc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < p.H; h += kThreads) {
      float v = 0.f;
      for (long long bc = 0; bc < (long long)p.batch * p.nc; ++bc)
        v += p.dA_part[bc * p.H + h];
      p.dA[h] = v / p.A[h];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at P = 64, N = 64 NA (NA = 1 or 2 atoms of 64 state columns), chunk Q
// of 64, 128 or 256 (the training paths of zamba2-1.2b, N 64, and
// mamba2-1.3b, N 128): `ssd_bwd_wgmma`, three kernels on wgmma + TMA
// (hopper_sm90.cuh), each templated on NA, then ssd_bwd_dt and
// ssd_bwd_reduce above, which read the scratch these write in the layout the
// fp32 kernels write it.  A row of B, C or a state is NA 128-byte swizzle
// atoms, loaded as NA boxes of 64 columns; a product over N takes 4 NA
// k-steps, a product whose columns are N one m64nN wgmma (n64 or n128).
//  (A) `ssd_bwd_states_wgmma`, one block per (batch, head), two warpgroups
//      of which warpgroup wg < NA holds the state's columns 64 wg .. 64 wg +
//      63 in fp32 accumulator registers (at N 64 the second one only shares
//      the scan and the weighting), as the forward's state pass
//      (`ssd_state_wgmma`): the
//      forward recurrence h <- h exp(cum_last) + (x w)^T B over the chunks,
//      w_j = dt_j exp(cum_last - cum_j), then the reverse one
//      dh <- dh exp(cum_last) + (dy e)^T C from the last chunk down,
//      e_i = exp(cum_i).  (x w) and (dy e) are each the sum of two bf16
//      parts (hi, lo), so the states keep some 16 bits of each term.  It
//      writes what (B) and (C) read: cum and dt of each chunk (fp32), h_c and
//      dh_{c+1} (bf16: they are operands of bf16 products there), and from
//      the registers exp(cum_last) <h_c, dh_{c+1}> (h_c as (B) and (C) read
//      it) and the gradient of the initial state (fp32).  x, B, dy and C
//      arrive by TMA in 64-row sub-tiles through a ring of four stages.
//      This one kernel replaces `ssd_bwd_chunk_state` and
//      `ssd_bwd_state_scan`: no fp32 [B, nc, H, P, N] scratch.
//  (B) `ssd_bwd_dxdb_wgmma`, the column owner: one block per (batch, chunk,
//      64-row tile j, tile of up to 8 heads of one group); for each head and
//      each row tile i >= j, with S = dt_j x_j.dy_i^T and K = B_j.C_i^T
//      (both [j x i], wgmma from shared memory): M^T = L o K and
//      G^T = L o S in fp32 registers, rounded to bf16 only as the A
//      operands of du_j += M^T dy_i and dB_j += G^T C_i; the sums over i of
//      dS = M o S for the cum_j terms.  Then the terms from dh_{c+1}:
//      du_j += w B_j.dh^T, s_j = u_j . that, dB_j += w dt_j x_j.dh.  It
//      writes dx, x.du, s_j, the cum_j terms and its part of dA; dB of the
//      block's heads summed in registers into the partials of
//      ssd_bwd_reduce.
//  (C) `ssd_bwd_dc_wgmma`, the row owner: one block per (batch, chunk,
//      64-row tile i, head tile); for each head and each row tile j <= i
//      the same two products, G = L o S rounded to bf16 for
//      dC_i += G B_j, and the row sums of dS and the pairs' part of dA;
//      then dC_i += e_i dy_i.h_c and dy_i . y_inter_i = C_i . that.  It adds
//      its cum_i terms and its part of dA to what (B) wrote (the stream
//      orders the two), and writes dC's partials.
// (B) and (C) are K1b's two kernels with the operands renamed (C <-> Q,
// B <-> K, x dt <-> V, dy <-> dO; no softmax), each computing the two pair
// products, so no block waits for another's sums.  Each block has two
// warpgroups that take alternate heads of its tile, each with two head slots
// (the head's fixed tile, its state and its cum and dt) and a ring of two
// 64-row tiles, which its thread 0 fills by TMA as soon as the warpgroup is
// done with a slot (a warpgroup barrier).  No producer warp: at N 128 (B)
// holds dB (64 registers; 32 at N 64), du (32), both pair products (64) and
// their bf16 fragments (32), and with a producer warp or warpgroup ptxas
// capped a thread at 168 registers (it counts 288 threads as 384), spilled,
// and serialized the wgmmas (C7512); 256 threads leave 255.  The block's own tile
// and the other operand's tiles of the group (B_j and C_i, i >= j, or C_i
// and B_j, j <= i) stay in shared memory for all its heads.  The two
// warpgroups' sums of dB or dC meet in shared memory in a fixed order.
// Rows past S load as zeros (TMA's out-of-bounds fill) with dt = 0, so they
// add nothing.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 4;  // ring of (A)
constexpr int kNW = 2;      // consumer warpgroups of (B) and (C)
constexpr int kRing = 2;    // 64-row tiles in each warpgroup's ring
constexpr int kTileBytes = 8192;   // [64][64] bf16

// [NA][64][64] bf16: a tile of N = 64 NA columns (B, C or a state)
template <int NA>
__host__ __device__ constexpr int wide_bytes() {
  return NA * kTileBytes;
}

// Elements (r, col) and (r, col + 1) of a [atoms][64][64] swizzled tile, col
// even: the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its atom.
__device__ __forceinline__ float2 tile_pair(const bf16* tile, int r, int col) {
  const bf16* at = tile + (col / 64) * 64 * 64 + r * 64 +
                   ((((col % 64) / 8) ^ (r & 7)) * 8) + col % 8;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
}

// The sum of v over the 4 threads of a quad (the threads that share the rows
// of a wgmma accumulator), in one order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The sum of v over a warpgroup in one order: a tree within each warp, then
// the four warps in order, through red [4] and named barrier `bar`; every
// thread of the warpgroup calls it, thread 0 of the warpgroup gets the sum.
__device__ __forceinline__ float warpgroup_sum(float v, float* red, int bar) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int t = threadIdx.x % 128;
  if (t % 32 == 0) red[t / 32] = v;
  named_barrier(bar, 128);
  const float total = red[0] + red[1] + red[2] + red[3];
  named_barrier(bar, 128);  // red is read before the next call writes it
  return total;
}

template <int NA>
constexpr size_t states_smem_bytes() {
  // slack; stages of x or dy [64][64] and B or C [NA][64][64]; the lo part of
  // the weighted tile; cum, dt and the weights of a chunk; warp sums (scan,
  // dot); barriers
  return 1024 + kStages * (kTileBytes + wide_bytes<NA>()) + 8192 + 3 * 256 * 4 +
         16 * 4 + kStages * 8;
}

template <int NT, int NA>  // NT = Q / 64 sub-tiles a chunk, NA = N / 64
__global__ void __launch_bounds__(256) ssd_bwd_states_wgmma(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tc,
    BwdParams p) {
  constexpr int Q = NT * 64, N = 64 * NA, kStage = kTileBytes + wide_bytes<NA>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  // stage s: x or dy at s * kStage, B or C (NA 64-column atoms) 8 KB after it
  bf16* Xlo = reinterpret_cast<bf16*>(base + kStages * kStage);  // [64][64]
  float* cum = reinterpret_cast<float*>(Xlo + 64 * 64);
  float* dts = cum + 256;
  float* wts = dts + 256;
  float* wsum = wts + 256;  // [8] the scan's
  float* dsum = wsum + 8;   // [8] the dot's
  uint64_t* full = reinterpret_cast<uint64_t*>(dsum + 8);

  const int h = blockIdx.x, b = blockIdx.y;
  const int H = p.H, S = p.S, nc = p.nc;
  const int grp = h / (H / p.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warpgroup wg holds the state's columns 64 wg .. 64 wg + 63, if wg < NA
  const int wg = tid / 128, wwarp = warp % 4;
  const bool holds = NA == 2 || warp_index() < 4;
  const int g = lane / 4, qd = lane % 4;
  // units: the chunks' sub-tiles of (x, B) from the first chunk on, then of
  // (dy, C) from the last chunk down
  const int n_units = nc * NT;

  auto issue = [&](int u) {  // unit u into stage u % 4
    unsigned char* st = base + (u % kStages) * kStage;
    const bool fwd = u < n_units;
    const int v = fwd ? u : u - n_units;
    const int row = (fwd ? v / NT : nc - 1 - v / NT) * Q + (v % NT) * 64;
    const CUtensorMap* rows_map = fwd ? &tx : &tdy;
    const CUtensorMap* cols_map = fwd ? &tb : &tc;
    mbar_expect_tx(full + u % kStages, kStage);
    tma_load_4d(st, rows_map, full + u % kStages, 0, h, row, b);
    for (int a = 0; a < NA; ++a)
      tma_load_4d(st + kTileBytes * (1 + a), cols_map, full + u % kStages, 64 * a, grp,
                  row, b);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < min(kStages, 2 * n_units); ++u) issue(u);

  // this warpgroup's 64 columns of a [P, N] state in the accumulator layout:
  // acc[i] is (p = 16 wwarp + g + 8 ((i/2)%2), n = 64 wg + 8 (i/4) + 2 qd +
  // i%2)
  const long long bh = ((long long)b * H + h) * 64 * N;
  auto pos = [&](int i) {
    return (wwarp * 16 + g + 8 * ((i / 2) % 2)) * N + 64 * wg + 8 * (i / 4) + 2 * qd;
  };
  const float a = p.A[h];

  // dt of chunk c, 0 past S, this thread's row
  auto load_dt = [&](int c) {
    return (tid < min(Q, S - c * Q)) ? p.dt[((long long)b * S + c * Q + tid) * H + h]
                                     : 0.f;
  };
  // cum = cumsum(dt A) and dt of the chunk into shared memory: one element a
  // thread, a scan within each warp, then over the warps' sums
  auto scan = [&](float d) {
    float incl = (tid < Q) ? d * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    __syncthreads();  // the previous chunk no longer reads cum, dts, wsum
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += wsum[w];
    if (tid < Q) {
      cum[tid] = incl;
      dts[tid] = d;
    }
    __syncthreads();
  };

  // One pass a chunk: the chunks from the first on for h (acc starts from
  // h0), then from the last down for dh (acc starts again from dhT: h after
  // the last chunk is not an output).  In each, acc^T += (tile w)^T . cols
  // over the chunk's NT sub-tiles, w in wts.
  bf16* hb = static_cast<bf16*>(p.hb);
  bf16* dhb = static_cast<bf16*>(p.dhb);
  float acc[32];
  float d_next = load_dt(0);  // loaded one pass ahead
  for (int q = 0; q < 2 * nc; ++q) {
    const bool fwd = q < nc;
    const int c = fwd ? q : 2 * nc - 1 - q;
    const float d = d_next;
    if (q + 1 < 2 * nc) d_next = load_dt(q + 1 < nc ? q + 1 : 2 * nc - 2 - q);
    if ((q == 0 || q == nc) && holds) {
      const float* from = fwd ? p.h0 : p.dhT;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        float2 v = make_float2(0.f, 0.f);
        if (from) v = *reinterpret_cast<const float2*>(from + bh + pos(i));
        acc[i] = v.x;
        acc[i + 1] = v.y;
      }
    }
    scan(d);
    const long long bch = ((long long)b * nc + c) * H + h;
    const long long at = bch * 64 * N;
    const float cum_last = cum[Q - 1];
    const float decay = expf(cum_last);
    if (fwd) {
      if (tid < Q) {
        p.cum[bch * p.cum_ld + tid] = cum[tid];
        p.cum[bch * p.cum_ld + Q + tid] = dts[tid];
        wts[tid] = dts[tid] * expf(cum_last - cum[tid]);
      }
      // h_c in bf16, then its decay over the chunk
      if (holds) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          *reinterpret_cast<uint32_t*>(hb + at + pos(i)) = pack_bf16(acc[i], acc[i + 1]);
          acc[i] *= decay;
          acc[i + 1] *= decay;
        }
      }
      __syncthreads();  // wts is set
    } else {
      if (tid < Q) wts[tid] = expf(cum[tid]);
      // dh_{c+1} in bf16; exp(cum_last) <h_c, dh_{c+1}> with h_c as the other
      // kernels read it (this thread wrote those elements in the forward
      // pass); then the decay
      float dot = 0.f;
      if (holds) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          *reinterpret_cast<uint32_t*>(dhb + at + pos(i)) = pack_bf16(acc[i], acc[i + 1]);
          const float2 hv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hb + at + pos(i)));
          dot = fmaf(hv.x, acc[i], dot);
          dot = fmaf(hv.y, acc[i + 1], dot);
          acc[i] *= decay;
          acc[i + 1] *= decay;
        }
      }
      // the block's sum in one order: a tree within each warp, then the warps
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) dsum[warp] = dot;
      __syncthreads();  // wts and dsum are set
      if (tid == 0) {
        float total = 0.f;
        for (int w = 0; w < 8; ++w) total += dsum[w];
        p.hdh[bch] = decay * total;
      }
    }

    for (int t = 0; t < NT; ++t) {
      const int u = q * NT + t;
      unsigned char* st = base + (u % kStages) * kStage;
      mbar_wait(full + u % kStages, (u / kStages) & 1);
      // tile w -> hi (in place) and lo, 16 bytes at a time.  The swizzle only
      // permutes 16-byte chunks inside a 128-byte row, so chunk k belongs to
      // row k / 8 and hi and lo keep the tile's layout.
#pragma unroll
      for (int k = tid; k < 512; k += 256) {
        const float w = wts[t * 64 + k / 8];
        uint4* px = reinterpret_cast<uint4*>(st) + k;
        uint4 xv4 = *px, vlo;
        uint32_t* pv = reinterpret_cast<uint32_t*>(&xv4);
        uint32_t* pl = reinterpret_cast<uint32_t*>(&vlo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(pv + e);
          const float f0 = __low2float(xv) * w, f1 = __high2float(xv) * w;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(f0, f1);
          pv[e] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[e] = pack_bf16(f0 - __low2float(hi), f1 - __high2float(hi));
        }
        *px = xv4;
        reinterpret_cast<uint4*>(Xlo)[k] = vlo;
      }
      fence_proxy_async();
      __syncthreads();
      // A = (tile w)^T [P x 64 rows] MN-major, B = this warpgroup's 64
      // columns of the [64 rows x N] tile, MN-major
      if (holds) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = sw128_desc(st + 8192 + wg * 8192 + kk * 2048, 8192, 1024);
          wgmma_ss_n64<1, 1>(acc, sw128_desc(st + kk * 2048, 8192, 1024), db, 1);
          wgmma_ss_n64<1, 1>(acc, sw128_desc(reinterpret_cast<unsigned char*>(Xlo) + kk * 2048, 8192, 1024), db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncthreads();  // stage u % 4 and Xlo are free
      if (tid == 0 && u + kStages < 2 * n_units) issue(u + kStages);
    }
  }
  if (holds) {
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(p.dh0 + bh + pos(i)) = make_float2(acc[i], acc[i + 1]);
  }
}

// Shared memory of (B) and (C): the block's own tile [NA][64][64] and the
// other operand's tiles [NT][NA][64][64] (tile k at k * kWide); for each
// consumer warpgroup two head slots, each the head's fixed tile [64][64], its
// state [NA][64][64] and its cum then dt [2][Q] fp32, and a ring of kRing
// [64][64] tiles; then the barriers and each warpgroup's reduction scratch.
template <int NT, int NA>
struct PairLayout {
  static constexpr int kWide = wide_bytes<NA>();
  static constexpr int kCdt = ((NT * 512 + 1023) / 1024) * 1024;
  static constexpr int kHead = kTileBytes + kWide + kCdt;
  static constexpr int kRes = kWide * (1 + NT);
  static constexpr int kPerWg = 2 * kHead + kRing * kTileBytes;
  static constexpr int kBars = 1 + kNW * (2 + kRing);
  static constexpr size_t kBytes = 1024 + kRes + kNW * kPerWg + 8 * kBars + 4 * 4 * kNW;
  static_assert(kBytes <= 232448, "more than 227 KB");
  static_assert(kHead % 1024 == 0, "1,024-byte atoms");
  // the other warpgroup's sums of dB or dC (fp32, 32 NA a thread) fit its slots
  static_assert(2 * kHead >= 32 * NA * 128 * 4, "exchange");
};

// One block's barriers, each completed by TMA's byte count: res (the
// resident tiles); per warpgroup w its two head slots', then its ring's
struct PairBars {
  uint64_t *res, *hfull, *rfull;
  __device__ PairBars(uint64_t* bars, int w) {
    res = bars;
    hfull = bars + 1 + w * (2 + kRing);
    rfull = hfull + 2;
  }
};

// Where a block of (B) or (C) is: its 64-row tile t of chunk c of batch b,
// heads [h_first, h_first + heads) of group grp; the other tiles it pairs t
// with are [lo, hi); n_valid tiles of the chunk hold a row < S.
struct PairItem {
  int b, c, c0, rows, t, ht, h_first, grp, lo, hi, n_valid;
};

// The loads of (B) and (C), each issued by one thread: the resident tiles
// (the block's own tile from `own`, the other operand's tiles [lo, hi) from
// `other`); the n-th head of warpgroup w into its slot n % 2 (the fixed
// tile from `fixed`, the state from `state`, cum and dt); and ring tile m of
// warpgroup w (tile lo + m % (hi - lo) of `moving` for its head
// m / (hi - lo)) into its ring slot m % kRing.
template <int NA>
__device__ __forceinline__ void load_resident(const PairItem& it, unsigned char* base,
                                              uint64_t* res, const CUtensorMap* own,
                                              const CUtensorMap* other) {
  constexpr int kWide = wide_bytes<NA>();
  mbar_expect_tx(res, (1 + it.hi - it.lo) * kWide);
  for (int a = 0; a < NA; ++a) {
    tma_load_4d(base + a * kTileBytes, own, res, 64 * a, it.grp, it.c0 + it.t * 64, it.b);
    for (int k = it.lo; k < it.hi; ++k)
      tma_load_4d(base + kWide * (1 + k) + a * kTileBytes, other, res, 64 * a, it.grp,
                  it.c0 + k * 64, it.b);
  }
}

template <int NT, int NA>
__device__ __forceinline__ void load_head(const PairItem& it, const BwdParams& p, int w,
                                          int n, unsigned char* slots, uint64_t* hfull,
                                          const CUtensorMap* fixed,
                                          const CUtensorMap* state) {
  constexpr int Q = NT * 64, kWide = wide_bytes<NA>();
  const int s = n & 1, h = it.h_first + w + n * kNW;
  unsigned char* hs = slots + s * PairLayout<NT, NA>::kHead;
  mbar_expect_tx(hfull + s, kTileBytes + kWide + 2 * Q * 4);
  tma_load_4d(hs, fixed, hfull + s, 0, h, it.c0 + it.t * 64, it.b);
  const long long bch = ((long long)it.b * p.nc + it.c) * p.H + h;
  for (int a = 0; a < NA; ++a)
    tma_load_2d(hs + kTileBytes * (1 + a), state, hfull + s, 64 * a,
                static_cast<int>(bch * 64));
  bulk_load(hs + kTileBytes + kWide, p.cum + bch * p.cum_ld, 2 * Q * 4, hfull + s);
}

template <int NT, int NA>
__device__ __forceinline__ void load_ring(const PairItem& it, int w, int m,
                                          unsigned char* slots, uint64_t* rfull,
                                          const CUtensorMap* moving) {
  const int cnt = it.hi - it.lo, r = m % kRing;
  const int h = it.h_first + w + (m / cnt) * kNW, k = it.lo + m % cnt;
  mbar_expect_tx(rfull + r, kTileBytes);
  tma_load_4d(slots + 2 * PairLayout<NT, NA>::kHead + r * kTileBytes, moving, rfull + r,
              0, h, it.c0 + k * 64, it.b);
}

// The block's item of (B) or (C): the grid walks (tile, head tile, batch and
// chunk) with the tile fastest, longest first, so that the tiles of one
// (batch, chunk, head tile) run side by side and share their inputs in L2.
template <int NT, bool kRows>
__device__ __forceinline__ PairItem pair_item(const BwdParams& p) {
  constexpr int Q = NT * 64;
  PairItem it;
  const int n_ht = p.H / p.heads;
  const int k = static_cast<int>(blockIdx.x % NT);
  const int rem = static_cast<int>(blockIdx.x / NT);
  it.ht = rem % n_ht;
  const int bc = rem / n_ht;
  it.b = bc / p.nc;
  it.c = bc % p.nc;
  it.c0 = it.c * Q;
  it.rows = min(Q, p.S - it.c0);
  it.n_valid = (it.rows + 63) / 64;
  // the column owner's tile j pairs with i in [j, n_valid): j = 0 first; the
  // row owner's tile i with j in [0, i]: the last first
  it.t = kRows ? NT - 1 - k : k;
  it.lo = kRows ? 0 : it.t;
  it.hi = kRows ? it.t + 1 : it.n_valid;
  it.h_first = it.ht * p.heads;
  it.grp = it.h_first / (p.H / p.G);
  return it;
}

__device__ __forceinline__ void pair_init_barriers(uint64_t* bars, int count) {
  for (int i = 0; i < count; ++i) mbar_init(bars + i, 1);
  mbar_fence_init();
}

// The two pair products of one (pair of tiles, head): k = own . other^T over
// N (4 NA k-steps) and s = fixed . moving^T over P (4 k-steps), [64 x 64] each
template <int NA>
__device__ __forceinline__ void pair_products(float (&k)[32], float (&s)[32],
                                              const bf16* own, const bf16* other,
                                              const bf16* fixed, const bf16* moving) {
  wgmma_fence();
  wgmma_ss_n64_first<0, 0>(k, kmajor<64>(own, 0), kmajor<64>(other, 0));
#pragma unroll
  for (int kk = 1; kk < 4 * NA; ++kk) wgmma_ss_n64<0, 0>(k, kmajor<64>(own, kk), kmajor<64>(other, kk), 1);
  wgmma_ss_n64_first<0, 0>(s, kmajor<64>(fixed, 0), kmajor<64>(moving, 0));
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_ss_n64<0, 0>(s, kmajor<64>(fixed, kk), kmajor<64>(moving, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
}

// (B): du, dx, dB, s_j, x.du, the cum_j terms and their part of dA
template <int NT, int NA>
__global__ void __launch_bounds__(128 * kNW, 1) ssd_bwd_dxdb_wgmma(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tdy,
    const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tdh, BwdParams p) {
  using L = PairLayout<NT, NA>;
  constexpr int Q = NT * 64, N = 64 * NA, kWide = L::kWide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kRes + kNW * L::kPerWg);
  float* reds = reinterpret_cast<float*>(bars + L::kBars);  // [kNW][4]
  const PairItem it = pair_item<NT, false>(p);
  if (it.t >= it.n_valid) return;  // no valid row: the whole block leaves at once
  const int tid = threadIdx.x;
  if (tid == 0) pair_init_barriers(bars, L::kBars);
  __syncthreads();

  const int warp_id = warp_index();
  const int w = warp_id / 4, warp = warp_id % 4, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4, t = tid % 128;
  const int rA = warp * 16 + g;  // this thread's rows rA and rA + 8 of tile j
  const int j = it.t;
  const PairBars bar(bars, w);
  const bf16* Bj = reinterpret_cast<const bf16*>(base);
  unsigned char* slots = base + L::kRes + w * L::kPerWg;
  const int S = p.S, H = p.H;
  // this warpgroup's heads, and its ring tiles: hi - lo a head
  const int n_heads = (p.heads - w + kNW - 1) / kNW, n_ring = n_heads * (it.hi - it.lo);
  if (t == 0) {
    if (w == 0) load_resident<NA>(it, base, bar.res, &tb, &tc);
    for (int n = 0; n < min(2, n_heads); ++n) load_head<NT, NA>(it, p, w, n, slots, bar.hfull, &tx, &tdh);
    for (int m = 0; m < min(kRing, n_ring); ++m) load_ring<NT, NA>(it, w, m, slots, bar.rfull, &tdy);
  }

  float dB[N / 2];  // dB_j [64 x N] of this warpgroup's heads
#pragma unroll
  for (int e = 0; e < N / 2; ++e) dB[e] = 0.f;
  mbar_wait(bar.res, 0);
  int ring = 0;
  for (int n = 0;; ++n) {
    const int h = it.h_first + w + n * kNW;
    if (h >= it.h_first + p.heads) break;
    const int s = n & 1;
    const unsigned char* hs = slots + s * L::kHead;
    const bf16* Xj = reinterpret_cast<const bf16*>(hs);
    const bf16* dH = reinterpret_cast<const bf16*>(hs + kTileBytes);  // dh_{c+1} [P][N]
    const float* cw = reinterpret_cast<const float*>(hs + kTileBytes + kWide);
    const float* dw = cw + Q;
    mbar_wait(bar.hfull + s, (n >> 1) & 1);
    float cj[2], dtj[2];  // cum and dt of this thread's rows
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      cj[hf] = cw[j * 64 + rA + 8 * hf];
      dtj[hf] = dw[j * 64 + rA + 8 * hf];
    }

    float du[32];            // du_j [64 x P]; the first k-step overwrites
    float cs[2] = {0.f, 0.f};  // sum over i of dS_ij, this thread's part
    for (int i = it.lo; i < it.hi; ++i, ++ring) {
      const int r = ring % kRing;
      const bf16* Dy = reinterpret_cast<const bf16*>(slots + 2 * L::kHead + r * kTileBytes);
      const bf16* Ci = reinterpret_cast<const bf16*>(base + kWide * (1 + i));
      mbar_wait(bar.rfull + r, (ring / kRing) & 1);
      // kt = B_j C_i^T and xy = x_j dy_i^T: element e is row j = rA + 8
      // ((e / 2) % 2), column i = 8 (e / 4) + 2 qd + e % 2 of the tiles
      float kt[32], xy[32];
      fence_regs(du);
      fence_regs(dB);
      pair_products<NA>(kt, xy, Bj, Ci, Xj, Dy);
      fence_regs(kt);
      fence_regs(xy);
      fence_regs(du);
      fence_regs(dB);
      // M^T = L o kt and G^T = L o (dt_j xy) as the bf16 A fragments of the
      // four k-steps over i; dS = M o S summed over i in fp32
      uint32_t ma[4][4], ga[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float mv[8], gv[8];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 16 * kk + 8 * hh + 2 * qd;
          const float2 ci = *reinterpret_cast<const float2*>(cw + i * 64 + col);
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2) {
            const int e = 8 * kk + 4 * hh + e2, hf = e2 >> 1, odd = e2 & 1;
            const float cum_i = odd ? ci.y : ci.x;
            // mask first: exp(cum_i - cum_j) overflows above the diagonal
            const bool seen = i > j || col + odd >= rA + 8 * hf;
            const float lv = seen ? fast_exp2((cum_i - cj[hf]) * kLog2e) : 0.f;
            const float sv = xy[e] * dtj[hf];
            const float m = lv * kt[e];
            cs[hf] = fmaf(m, sv, cs[hf]);
            mv[4 * hh + e2] = m;
            gv[4 * hh + e2] = lv * sv;
          }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          ma[kk][f] = pack_bf16(mv[2 * f], mv[2 * f + 1]);
          ga[kk][f] = pack_bf16(gv[2 * f], gv[2 * f + 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ma[kk]);
        fence_regs(ga[kk]);
      }
      fence_regs(du);
      fence_regs(dB);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<1>(du, ma[kk], mnmajor<64>(Dy, kk), i > j || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_cols<N, kTileBytes>(dB, ga[kk], mnmajor<64>(Ci, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(du);
      fence_regs(dB);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ma[kk]);
        fence_regs(ga[kk]);
      }
      named_barrier(1 + w, 128);  // the warpgroup is done with ring slot r
      if (t == 0 && ring + kRing < n_ring)
        load_ring<NT, NA>(it, w, ring + kRing, slots, bar.rfull, &tdy);
    }

    // from dh_{c+1}: di = B_j dh^T [64 x P], weighted by exp(cum_last - cum_j)
    float di[32];
    wgmma_fence();
    wgmma_ss_n64_first<0, 0>(di, kmajor<64>(Bj, 0), kmajor<64>(dH, 0));
#pragma unroll
    for (int kk = 1; kk < 4 * NA; ++kk) wgmma_ss_n64<0, 0>(di, kmajor<64>(Bj, kk), kmajor<64>(dH, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(di);
    fence_regs(du);
    const float cum_last = cw[Q - 1];
    const float wj[2] = {expf(cum_last - cj[0]), expf(cum_last - cj[1])};
    float sj[2] = {0.f, 0.f}, xd[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int hf = (e / 2) % 2, col = 8 * (e / 4) + 2 * qd;
      const float2 xv = tile_pair(Xj, rA + 8 * hf, col);
      const float v0 = di[e] * wj[hf], v1 = di[e + 1] * wj[hf];
      sj[hf] = fmaf(xv.x, v0, fmaf(xv.y, v1, sj[hf]));
      du[e] += v0;
      du[e + 1] += v1;
      xd[hf] = fmaf(xv.x, du[e], fmaf(xv.y, du[e + 1], xd[hf]));
    }
    // dx_j = dt_j du_j
    const long long row0 = (long long)it.b * S + it.c0 + j * 64;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = j * 64 + rA + 8 * hf;
      if (row >= it.rows) continue;
      bf16* dxr = static_cast<bf16*>(p.dx) + ((row0 + rA + 8 * hf) * H + h) * 64 + 2 * qd;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const int e = 4 * nn + 2 * hf;
        *reinterpret_cast<uint32_t*>(dxr + nn * 8) =
            pack_bf16(du[e] * dtj[hf], du[e + 1] * dtj[hf]);
      }
    }
    // per row: the cum_j terms of the pairs (- sum_i dS_ij), s_j and x_j.du_j;
    // the tile's part of A dA, s_j (cum_last - cum_j)
    float da = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float c_sum = quad_sum(cs[hf]);
      const float s_j = quad_sum(sj[hf]) * dtj[hf];
      const float x_du = quad_sum(xd[hf]);
      const int row = j * 64 + rA + 8 * hf;
      if (qd == 0 && row < it.rows) {
        const long long o = (row0 + rA + 8 * hf) * H + h;
        p.rdcum[o] = -c_sum;
        p.rs[o] = s_j;
        p.ddt[o] = x_du;
        da = fmaf(s_j, cum_last - cj[hf], da);
      }
    }
    da = warpgroup_sum(da, reds + 4 * w, 1 + w);
    const long long bch = ((long long)it.b * p.nc + it.c) * H + h;
    if (t == 0) p.da_tile[bch * NT + j] = da;

    // dB_j += w dt_j x_j dh: x_j [64 x P] K-major, dh [P x N] MN-major
    float xh[N / 2];
    fence_regs(dB);
    wgmma_fence();
    wgmma_ss_cols_first<N, 0, 1>(xh, kmajor<64>(Xj, 0), mnmajor<64>(dH, 0));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) wgmma_ss_cols<N, 0, 1>(xh, kmajor<64>(Xj, kk), mnmajor<64>(dH, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(xh);
    named_barrier(1 + w, 128);  // the warpgroup is done with head slot s
    if (t == 0 && n + 2 < n_heads) load_head<NT, NA>(it, p, w, n + 2, slots, bar.hfull, &tx, &tdh);
    const float wd[2] = {wj[0] * dtj[0], wj[1] * dtj[1]};
#pragma unroll
    for (int e = 0; e < N / 2; ++e) dB[e] = fmaf(xh[e], wd[(e / 2) % 2], dB[e]);
  }

  // warpgroup 1 hands its dB to warpgroup 0 through its own (spent) slots;
  // warpgroup 0 adds it to its own and writes the head tile's partial
  float* xch = reinterpret_cast<float*>(base + L::kRes + L::kPerWg);
  if (w == 1) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) xch[e * 128 + t] = dB[e];
  }
  named_barrier(3, 256);
  if (w == 1) return;
  const int n_ht = H / p.heads;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = j * 64 + rA + 8 * hf;
    if (row >= it.rows) continue;
    float* out = p.db_part +
                 (((long long)it.b * S + it.c0 + row) * n_ht + it.ht) * N + 2 * qd;
#pragma unroll
    for (int nn = 0; nn < N / 8; ++nn) {
      const int e = 4 * nn + 2 * hf;
      *reinterpret_cast<float2*>(out + nn * 8) =
          make_float2(dB[e] + xch[e * 128 + t], dB[e + 1] + xch[(e + 1) * 128 + t]);
    }
  }
}

// (C): dC, the cum_i terms and the rest of dA
template <int NT, int NA>
__global__ void __launch_bounds__(128 * kNW, 1) ssd_bwd_dc_wgmma(
    const __grid_constant__ CUtensorMap tdy, const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap th, BwdParams p) {
  using L = PairLayout<NT, NA>;
  constexpr int Q = NT * 64, N = 64 * NA, kWide = L::kWide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kRes + kNW * L::kPerWg);
  float* reds = reinterpret_cast<float*>(bars + L::kBars);  // [kNW][4]
  const PairItem it = pair_item<NT, true>(p);
  if (it.t >= it.n_valid) return;  // no valid row: the whole block leaves at once
  const int tid = threadIdx.x;
  if (tid == 0) pair_init_barriers(bars, L::kBars);
  __syncthreads();

  const int warp_id = warp_index();
  const int w = warp_id / 4, warp = warp_id % 4, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4, t = tid % 128;
  const int rA = warp * 16 + g;  // this thread's rows rA and rA + 8 of tile i
  const int i = it.t;
  const PairBars bar(bars, w);
  const bf16* Ci = reinterpret_cast<const bf16*>(base);
  unsigned char* slots = base + L::kRes + w * L::kPerWg;
  const int S = p.S, H = p.H;
  const int n_heads = (p.heads - w + kNW - 1) / kNW, n_ring = n_heads * (it.hi - it.lo);
  if (t == 0) {
    if (w == 0) load_resident<NA>(it, base, bar.res, &tc, &tb);
    for (int n = 0; n < min(2, n_heads); ++n) load_head<NT, NA>(it, p, w, n, slots, bar.hfull, &tdy, &th);
    for (int m = 0; m < min(kRing, n_ring); ++m) load_ring<NT, NA>(it, w, m, slots, bar.rfull, &tx);
  }

  float dC[N / 2];  // dC_i [64 x N] of this warpgroup's heads
#pragma unroll
  for (int e = 0; e < N / 2; ++e) dC[e] = 0.f;
  mbar_wait(bar.res, 0);
  int ring = 0;
  for (int n = 0;; ++n) {
    const int h = it.h_first + w + n * kNW;
    if (h >= it.h_first + p.heads) break;
    const int s = n & 1;
    const unsigned char* hs = slots + s * L::kHead;
    const bf16* Dy = reinterpret_cast<const bf16*>(hs);
    const bf16* Hc = reinterpret_cast<const bf16*>(hs + kTileBytes);  // h_c [P][N]
    const float* cw = reinterpret_cast<const float*>(hs + kTileBytes + kWide);
    const float* dw = cw + Q;
    mbar_wait(bar.hfull + s, (n >> 1) & 1);
    const float ci[2] = {cw[i * 64 + rA], cw[i * 64 + rA + 8]};

    float rsum[2] = {0.f, 0.f};  // sum over j of dS_ij, this thread's part
    float da = 0.f;              // the pairs' dS_ij (cum_i - cum_j)
    for (int j = it.lo; j < it.hi; ++j, ++ring) {
      const int r = ring % kRing;
      const bf16* Xj = reinterpret_cast<const bf16*>(slots + 2 * L::kHead + r * kTileBytes);
      const bf16* Bj = reinterpret_cast<const bf16*>(base + kWide * (1 + j));
      mbar_wait(bar.rfull + r, (ring / kRing) & 1);
      // kk_ = C_i B_j^T and yx = dy_i x_j^T: element e is row i = rA + 8
      // ((e / 2) % 2), column j = 8 (e / 4) + 2 qd + e % 2 of the tiles
      float kv[32], yx[32];
      fence_regs(dC);
      pair_products<NA>(kv, yx, Ci, Bj, Dy, Xj);
      fence_regs(kv);
      fence_regs(yx);
      fence_regs(dC);
      // G = L o (yx dt_j) as the bf16 A fragments of the four k-steps over
      // j; dS = L o kv o (yx dt_j) in fp32
      uint32_t ga[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float gv[8];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int col = 16 * kk + 8 * hh + 2 * qd;
          const float2 cjv = *reinterpret_cast<const float2*>(cw + j * 64 + col);
          const float2 djv = *reinterpret_cast<const float2*>(dw + j * 64 + col);
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2) {
            const int e = 8 * kk + 4 * hh + e2, hf = e2 >> 1, odd = e2 & 1;
            const float diff = ci[hf] - (odd ? cjv.y : cjv.x);
            // mask first: exp(cum_i - cum_j) overflows above the diagonal
            const bool seen = j < i || col + odd <= rA + 8 * hf;
            const float lv = seen ? fast_exp2(diff * kLog2e) : 0.f;
            const float sv = yx[e] * (odd ? djv.y : djv.x);
            const float ds = lv * kv[e] * sv;
            rsum[hf] += ds;
            da = fmaf(ds, diff, da);
            gv[4 * hh + e2] = lv * sv;
          }
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) ga[kk][f] = pack_bf16(gv[2 * f], gv[2 * f + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ga[kk]);
      fence_regs(dC);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_cols<N, kTileBytes>(dC, ga[kk], mnmajor<64>(Bj, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dC);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(ga[kk]);
      named_barrier(1 + w, 128);  // the warpgroup is done with ring slot r
      if (t == 0 && ring + kRing < n_ring)
        load_ring<NT, NA>(it, w, ring + kRing, slots, bar.rfull, &tx);
    }

    // from h_c: dC_inter = exp(cum_i) dy_i h_c; dy_i . y_inter_i is
    // C_i . dC_inter_i
    float yh[N / 2];
    wgmma_fence();
    wgmma_ss_cols_first<N, 0, 1>(yh, kmajor<64>(Dy, 0), mnmajor<64>(Hc, 0));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) wgmma_ss_cols<N, 0, 1>(yh, kmajor<64>(Dy, kk), mnmajor<64>(Hc, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yh);
    fence_regs(dC);
    named_barrier(1 + w, 128);  // the warpgroup is done with head slot s
    if (t == 0 && n + 2 < n_heads) load_head<NT, NA>(it, p, w, n + 2, slots, bar.hfull, &tdy, &th);
    const float ei[2] = {expf(ci[0]), expf(ci[1])};
    float yt[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < N / 2; e += 2) {
      const int hf = (e / 2) % 2, col = 8 * (e / 4) + 2 * qd;
      const float2 cv = tile_pair(Ci, rA + 8 * hf, col);
      const float v0 = yh[e] * ei[hf], v1 = yh[e + 1] * ei[hf];
      yt[hf] = fmaf(cv.x, v0, fmaf(cv.y, v1, yt[hf]));
      dC[e] += v0;
      dC[e + 1] += v1;
    }
    // per row: add the cum_i terms (sum_j dS_ij, dy_i . y_inter_i) to the
    // column owner's; the tile's part of A dA: the pairs' and
    // (dy_i . y_inter_i) cum_i, added to the column owner's
    const long long row0 = (long long)it.b * S + it.c0 + i * 64;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float r_sum = quad_sum(rsum[hf]);
      const float y_t = quad_sum(yt[hf]);
      const int row = i * 64 + rA + 8 * hf;
      if (qd == 0 && row < it.rows) {
        const long long o = (row0 + rA + 8 * hf) * H + h;
        p.rdcum[o] += r_sum + y_t;
        da = fmaf(y_t, ci[hf], da);
      }
    }
    da = warpgroup_sum(da, reds + 4 * w, 1 + w);
    const long long bch = ((long long)it.b * p.nc + it.c) * H + h;
    if (t == 0) p.da_tile[bch * NT + i] += da;
  }

  // warpgroup 1 hands its dC to warpgroup 0, as in (B)
  float* xch = reinterpret_cast<float*>(base + L::kRes + L::kPerWg);
  if (w == 1) {
#pragma unroll
    for (int e = 0; e < N / 2; ++e) xch[e * 128 + t] = dC[e];
  }
  named_barrier(3, 256);
  if (w == 1) return;
  const int n_ht = H / p.heads;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = i * 64 + rA + 8 * hf;
    if (row >= it.rows) continue;
    float* out = p.dc_part +
                 (((long long)it.b * S + it.c0 + row) * n_ht + it.ht) * N + 2 * qd;
#pragma unroll
    for (int nn = 0; nn < N / 8; ++nn) {
      const int e = 4 * nn + 2 * hf;
      *reinterpret_cast<float2*>(out + nn * 8) =
          make_float2(dC[e] + xch[e * 128 + t], dC[e + 1] + xch[(e + 1) * 128 + t]);
    }
  }
}

// x and dy [B, S, H, 64], B and C [B, S, G, N] as 4-D maps (columns, head
// or group, sequence, batch), boxes of 64 columns x 64 rows (a row of B or C
// is N / 64 boxes); h_c and dh_{c+1} [B nc H 64, N] as 2-D maps, boxes of
// 64 x 64.
struct BwdMaps {
  CUtensorMap x, dy, b, c, hb, dhb;
};

bool bwd_maps(const BwdParams& p, BwdMaps* m) {
  const cuuint32_t box4[4] = {64, 1, 64, 1}, box2[2] = {64, 64};
  const cuuint64_t B = p.batch, S = p.S, H = p.H, G = p.G, N = p.N;
  const cuuint64_t dx[4] = {64, H, S, B};
  const cuuint64_t sx[3] = {64 * 2, H * 64 * 2, S * H * 64 * 2};
  const cuuint64_t dbc[4] = {N, G, S, B};
  const cuuint64_t sbc[3] = {N * 2, G * N * 2, S * G * N * 2};
  const cuuint64_t dh[2] = {N, B * p.nc * H * 64};
  const cuuint64_t sh[1] = {N * 2};
  return make_map_bf16(&m->x, p.x, 4, dx, sx, box4) &&
         make_map_bf16(&m->dy, p.dy, 4, dx, sx, box4) &&
         make_map_bf16(&m->b, p.b, 4, dbc, sbc, box4) &&
         make_map_bf16(&m->c, p.c, 4, dbc, sbc, box4) &&
         make_map_bf16(&m->hb, p.hb, 2, dh, sh, box2) &&
         make_map_bf16(&m->dhb, p.dhb, 2, dh, sh, box2);
}

template <int NT, int NA>
cudaError_t launch_wgmma(const BwdParams& p, cudaStream_t stream) {
  constexpr size_t smem_a = states_smem_bytes<NA>(), smem_bc = PairLayout<NT, NA>::kBytes;
  static const cudaError_t attr_a = cudaFuncSetAttribute(
      ssd_bwd_states_wgmma<NT, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      ssd_bwd_dxdb_wgmma<NT, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bc));
  static const cudaError_t attr_c = cudaFuncSetAttribute(
      ssd_bwd_dc_wgmma<NT, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bc));
  if (attr_a != cudaSuccess) return attr_a;
  if (attr_b != cudaSuccess) return attr_b;
  if (attr_c != cudaSuccess) return attr_c;
  BwdMaps m;
  if (!bwd_maps(p, &m)) return cudaErrorInvalidValue;
  ssd_bwd_states_wgmma<NT, NA><<<dim3(p.H, p.batch), 256, smem_a, stream>>>(m.x, m.b, m.dy, m.c, p);
  cudaError_t e = counted(cudaGetLastError(), kStatesWgmma);
  if (e != cudaSuccess) return e;
  // the column owner first: the row owner adds to what it writes
  const unsigned grid = static_cast<unsigned>(NT) * p.batch * p.nc * (p.H / p.heads);
  ssd_bwd_dxdb_wgmma<NT, NA><<<grid, 128 * kNW, smem_bc, stream>>>(m.x, m.dy, m.b, m.c, m.dhb, p);
  e = counted(cudaGetLastError(), kDxdbWgmma);
  if (e != cudaSuccess) return e;
  ssd_bwd_dc_wgmma<NT, NA><<<grid, 128 * kNW, smem_bc, stream>>>(m.dy, m.x, m.c, m.b, m.hb, p);
  return counted(cudaGetLastError(), kDcWgmma);
}

template <int NA>
cudaError_t launch_wgmma_q(const BwdParams& p, cudaStream_t stream) {
  switch (p.Q) {
    case 64: return launch_wgmma<1, NA>(p, stream);
    case 128: return launch_wgmma<2, NA>(p, stream);
    default: return launch_wgmma<4, NA>(p, stream);
  }
}

// Heads a block of pass 3 serves: the largest of 8, 4, 2, 1 that divides the
// heads of a group (they share B and C, and their dB and dC add up).
int heads_per_block(int H, int G) {
  int heads = kMaxHeads;
  while ((H / G) % heads) heads /= 2;
  return heads;
}

// The fp32 scratch: its size in floats and, where `p` is given, its parts
// (carved out of p->cum onwards, in this order).  ssd_bwd_wgmma keeps dt
// beside cum and the two states in bf16.
long long carve(int batch, int S, int H, int G, int P, int N, int Q,
                int variant, BwdParams* p) {
  const long long nc = (S + Q - 1) / Q, bnh = batch * nc * H;
  const long long rows = (long long)batch * S;
  const long long tiles = H / heads_per_block(H, G);
  float* base = p ? p->cum : nullptr;
  long long total = 0;
  auto take = [&](long long n) {
    float* at = base ? base + total : nullptr;
    total += n;
    return at;
  };
  const int bf16_states = variant == kBwdWgmma ? 2 : 1;
  const int cum_ld = variant == kBwdWgmma ? 2 * Q : Q;
  float* cum = take(bnh * cum_ld);
  float* st = take(bnh * P * N / bf16_states);
  float* dst = take(bnh * P * N / bf16_states);
  float* hdh = take(bnh);
  float* rdcum = take(rows * H);
  float* rs = take(rows * H);
  float* da_tile = take(bnh * (Q >= 64 ? Q / 64 : 1));
  float* dA_part = take(bnh);
  float* db_part = take(rows * tiles * N);
  float* dc_part = take(rows * tiles * N);
  if (p) {
    p->cum = cum; p->st = st; p->dst = dst; p->hdh = hdh; p->rdcum = rdcum;
    p->hb = st; p->dhb = dst; p->cum_ld = cum_ld;
    p->rs = rs; p->da_tile = da_tile; p->dA_part = dA_part; p->db_part = db_part; p->dc_part = dc_part;
  }
  return total;
}

// ssd_bwd_dt, then ssd_bwd_reduce: the last two passes of either variant
template <typename Tout>
cudaError_t launch_tail(const BwdParams& p, cudaStream_t stream) {
  ssd_bwd_dt<<<dim3((p.H + 31) / 32, p.nc, p.batch), 32 * (p.Q / kDtRows), 0, stream>>>(p);
  cudaError_t e = counted(cudaGetLastError(), kDt);
  if (e != cudaSuccess) return e;
  const long long n5 = (long long)p.batch * p.S * p.G * p.N;
  ssd_bwd_reduce<Tout><<<static_cast<unsigned>((n5 + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(p);
  return counted(cudaGetLastError(), kReduce);
}

template <typename Tin>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  // More than 48 KB of dynamic shared memory has to be asked for, once for
  // each instance, for the largest P and N it takes.
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      ssd_bwd_chunk_state<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(state_smem_bytes(kMaxP, kMaxN)));
  static const cudaError_t attr64 = cudaFuncSetAttribute(
      ssd_bwd_chunk_grads<Tin, 64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * grads_smem_floats(64, kMaxP, kMaxN)));
  static const cudaError_t attr32 = cudaFuncSetAttribute(
      ssd_bwd_chunk_grads<Tin, 32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * grads_smem_floats(32, kMaxP, kMaxN)));
  if (attr1 != cudaSuccess) return attr1;
  if (attr64 != cudaSuccess) return attr64;
  if (attr32 != cudaSuccess) return attr32;

  ssd_bwd_chunk_state<Tin><<<dim3(p.H, p.nc, p.batch), kThreads,
                             state_smem_bytes(p.P, p.N), stream>>>(p);
  cudaError_t e = counted(cudaGetLastError(), kChunkState);
  if (e != cudaSuccess) return e;

  ssd_bwd_state_scan<<<dim3(p.H, p.batch), kThreads, 0, stream>>>(p);
  e = counted(cudaGetLastError(), kStateScan);
  if (e != cudaSuccess) return e;

  // row tiles of 64, or of the whole chunk when it is shorter
  const int T = p.Q >= 64 ? 64 : 32;
  const dim3 grid3((p.Q / T) * (p.H / p.heads), p.nc, p.batch);
  const size_t smem3 = sizeof(float) * grads_smem_floats(T, p.P, p.N);
  if (T == 64)
    ssd_bwd_chunk_grads<Tin, 64><<<grid3, kThreads, smem3, stream>>>(p);
  else
    ssd_bwd_chunk_grads<Tin, 32><<<grid3, kThreads, smem3, stream>>>(p);
  e = counted(cudaGetLastError(), kChunkGrads);
  if (e != cudaSuccess) return e;
  return launch_tail<Tin>(p, stream);
}

// Whether `variant` has kernels for these sizes (dtype aside): the fp32 pipes
// every size the wrapper takes, wgmma only P 64, N 64 or 128, chunk 64 and up.
bool takes(int batch, int S, int H, int G, int P, int N, int Q, int variant) {
  const bool sizes = batch >= 1 && S >= 1 && (Q == 32 || Q == 64 || Q == 128 || Q == 256) &&
                     P >= 4 && P % 4 == 0 && P <= kMaxP && N >= 4 && N % 4 == 0 &&
                     N <= kMaxN && G >= 1 && H >= G && H % G == 0;
  if (variant == kBwdWgmma) return sizes && P == 64 && (N == 64 || N == 128) && Q >= 64;
  return sizes && variant == kBwdFp32Pipes;
}

}  // namespace

// The fp32 scratch the backward's `variant` needs, in floats (the wrapper
// allocates it); -1 for sizes it does not take.
extern "C" long long ssd_bwd_scratch_floats(int batch, int S, int H, int G,
                                            int P, int N, int Q, int variant) {
  if (!takes(batch, S, H, G, P, N, Q, variant)) return -1;
  return carve(batch, S, H, G, P, N, Q, variant, nullptr);
}

// dtype of x, B, C, dy and of dx, dB, dC: 0 = float32, 1 = bfloat16; dt, A,
// the states, ddt and dA are float32.  Every tensor is contiguous.  h0 and
// dhT may be null (a zero state, a zero gradient); dh0 is always written.
// `scratch` holds ssd_bwd_scratch_floats() floats for `variant`, the
// wrapper's choice (kernel.variant_bwd): 0 = the five kernels on the fp32
// pipes; 1 = the three wgmma kernels and the last two, bf16 at P 64, N 64 or
// 128, Q >= 64 only, with x, B, C and dy on 16-byte boundaries (TMA; the wrapper
// checks).  Returns the launches' cudaError_t as an int
// (cudaErrorInvalidValue for a variant that cannot take these inputs).
extern "C" int ssd_bwd(const void* x, const float* dt, const float* A,
                       const void* b, const void* c, const float* h0,
                       const void* dy, const float* dhT, void* dx, float* ddt,
                       float* dA, void* db, void* dc, float* dh0, float* scratch,
                       int batch, int S, int H, int G, int P, int N, int Q,
                       int dtype, int variant, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (scratch == nullptr || !takes(batch, S, H, G, P, N, Q, variant) ||
      (variant == kBwdWgmma && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.x = x; p.dt = dt; p.A = A; p.b = b; p.c = c; p.h0 = h0; p.dy = dy;
  p.dhT = dhT; p.dx = dx; p.ddt = ddt; p.dA = dA; p.db = db; p.dc = dc;
  p.dh0 = dh0;
  p.batch = batch; p.S = S; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q;
  p.nc = (S + Q - 1) / Q;
  p.heads = heads_per_block(H, G);
  p.cum = scratch;
  carve(batch, S, H, G, P, N, Q, variant, &p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kBwdWgmma) {
    const cudaError_t e = N == 64 ? launch_wgmma_q<1>(p, s) : launch_wgmma_q<2>(p, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(launch_tail<__nv_bfloat16>(p, s));
  }
  return static_cast<int>(dtype ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// The library's CUDA kernels by index (null past the last), and the launches
// of each since the library was loaded.
extern "C" const char* ssd_bwd_kernel_name(int i) {
  return (i >= 0 && i < kNumKernels) ? kKernelNames[i] : nullptr;
}
extern "C" long long ssd_bwd_kernel_launches(int i) {
  return (i >= 0 && i < kNumKernels) ? g_launches[i] : -1;
}

extern "C" const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
