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
// Five kernels, one after the other on the stream:
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
//  4. `ssd_bwd_dt`, one thread per (batch, chunk, head): the reverse cumsum of
//     the cum gradients, ddt and the chunk's part of dA.
//  5. `ssd_bwd_reduce`: dB and dC summed over the head tiles of a group (in a
//     fixed order) and cast to the inputs' type; dA summed over batch and
//     chunks.
// No atomics: every sum has one order, so two calls give equal bits.
//
// What bounds it on this card.  At mamba2-1.3b's training shape (x
// [8,1024,64,64] bf16, N 128, chunk 256) the inputs and outputs are some
// 210 MB (0.06 ms at 3.35 TB/s) against some 95 GFLOP of products that the
// algebra needs (0.1 ms at the bf16 tensor-core peak): operations bound it.
// This first version runs every product on the fp32 pipes (67 TFLOP/s at
// best), from fp32 copies of the tiles in shared memory, 4 x 4 register
// tiles a thread: it is simple, it holds fp32 inputs to 1e-4, and it is the
// yardstick the tensor-core design after it (wgmma + TMA) will be measured
// against.  It computes some 150 GFLOP: the pair products (C.B^T and dy.u^T
// for each pair of 64-row tiles) twice, once for the column role and once
// for the row role, so that no block needs another's sums.  The fp32
// scratch of pass 2 is two [B, nc, H, P, N] arrays (67 MB each there).
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
// The C interface at the end returns cudaGetLastError() of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
enum SsdBwdKernel { kChunkState, kStateScan, kChunkGrads, kDt, kReduce, kNumKernels };
const char* const kKernelNames[kNumKernels] = {
    "ssd_bwd_chunk_state", "ssd_bwd_state_scan", "ssd_bwd_chunk_grads",
    "ssd_bwd_dt", "ssd_bwd_reduce"};
long long g_launches[kNumKernels] = {};

cudaError_t counted(cudaError_t e, SsdBwdKernel kernel) {
  if (e == cudaSuccess) ++g_launches[kernel];
  return e;
}

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
  float* cum;         // [B, nc, H, Q]
  float* st;          // [B, nc, H, P, N]: chunk state term, then h_c
  float* dst;         // [B, nc, H, P, N]: chunk term of dh, then dh_{c+1}
  float* hdh;         // [B, nc, H]: exp(cum_last) <h_c, dh_{c+1}>
  float* rdcum;       // [B, S, H]: the cum gradient of the pairs and y_inter
  float* rs;          // [B, S, H]: s_j = u_j . du_inter_j
  float* da_tile;     // [B, nc, H, Q / 64 or 1]: a row tile's part of A dA
  float* dA_part;     // [B, nc, H]: a chunk's A dA
  float* db_part;     // [B, S, H / heads, N]
  float* dc_part;
  int batch, S, H, G, P, N, Q, nc, heads;
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


__global__ void __launch_bounds__(128) ssd_bwd_dt(BwdParams p) {
  const int H = p.H, Q = p.Q, S = p.S;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p.batch * p.nc * H) return;
  const int h = static_cast<int>(idx % H);
  const long long bc = idx / H;  // idx = (b * nc + chunk) * H + h
  const int ci = static_cast<int>(bc % p.nc);
  const long long b = bc / p.nc;
  const int c0 = ci * Q, rows = min(Q, S - c0);
  const long long o = (b * S + c0) * H + h;  // the chunk's first row
  // s_j moves cum_j down and cum_last up: after the reverse cumsum, row k
  // holds the s of the rows before it
  float total_s = 0.f;
  for (int k = 0; k < rows; ++k) total_s += p.rs[o + (long long)k * H];
  const float a = p.A[h];
  float acc = p.hdh[idx] + total_s;
  for (int k = rows - 1; k >= 0; --k) {
    const long long r = o + (long long)k * H;
    acc += p.rdcum[r] - p.rs[r];
    p.ddt[r] += a * acc;
  }
  // A dA of the chunk: its row tiles' parts and <h_c, dh_{c+1}>'s
  const int T = Q >= 64 ? 64 : 32, nt = Q / T, n_valid = (rows + T - 1) / T;
  float v = 0.f;
  for (int t = 0; t < n_valid; ++t) v += p.da_tile[idx * nt + t];
  p.dA_part[idx] = v + p.hdh[idx] * p.cum[idx * Q + Q - 1];
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

// Heads a block of pass 3 serves: the largest of 8, 4, 2, 1 that divides the
// heads of a group (they share B and C, and their dB and dC add up).
int heads_per_block(int H, int G) {
  int heads = kMaxHeads;
  while ((H / G) % heads) heads /= 2;
  return heads;
}

// The fp32 scratch: its size in floats and, where `p` is given, its parts
// (carved out of p->cum onwards, in this order).
long long carve(int batch, int S, int H, int G, int P, int N, int Q,
                BwdParams* p) {
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
  float* cum = take(bnh * Q);
  float* st = take(bnh * P * N);
  float* dst = take(bnh * P * N);
  float* hdh = take(bnh);
  float* rdcum = take(rows * H);
  float* rs = take(rows * H);
  float* da_tile = take(bnh * (Q >= 64 ? Q / 64 : 1));
  float* dA_part = take(bnh);
  float* db_part = take(rows * tiles * N);
  float* dc_part = take(rows * tiles * N);
  if (p) {
    p->cum = cum; p->st = st; p->dst = dst; p->hdh = hdh; p->rdcum = rdcum;
    p->rs = rs; p->da_tile = da_tile; p->dA_part = dA_part; p->db_part = db_part; p->dc_part = dc_part;
  }
  return total;
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

  const long long n4 = (long long)p.batch * p.nc * p.H;
  ssd_bwd_dt<<<static_cast<unsigned>((n4 + 127) / 128), 128, 0, stream>>>(p);
  e = counted(cudaGetLastError(), kDt);
  if (e != cudaSuccess) return e;

  const long long n5 = (long long)p.batch * p.S * p.G * p.N;
  ssd_bwd_reduce<Tin><<<static_cast<unsigned>((n5 + kThreads - 1) / kThreads),
                        kThreads, 0, stream>>>(p);
  return counted(cudaGetLastError(), kReduce);
}

// The codes of kernel.VARIANT_CODES_BWD (a test holds the two to each other);
// the wrapper's variant_bwd() chooses.
enum SsdBwdVariant {
  kBwdFp32Pipes = 0,  // ssd_bwd_simt
};

bool takes(int batch, int S, int H, int G, int P, int N, int Q) {
  return batch >= 1 && S >= 1 && (Q == 32 || Q == 64 || Q == 128 || Q == 256) &&
         P >= 4 && P % 4 == 0 && P <= kMaxP && N >= 4 && N % 4 == 0 &&
         N <= kMaxN && G >= 1 && H >= G && H % G == 0;
}

}  // namespace

// The fp32 scratch the backward needs, in floats (the wrapper allocates it);
// -1 for sizes it does not take.
extern "C" long long ssd_bwd_scratch_floats(int batch, int S, int H, int G,
                                            int P, int N, int Q) {
  if (!takes(batch, S, H, G, P, N, Q)) return -1;
  return carve(batch, S, H, G, P, N, Q, nullptr);
}

// dtype of x, B, C, dy and of dx, dB, dC: 0 = float32, 1 = bfloat16; dt, A,
// the states, ddt and dA are float32.  Every tensor is contiguous.  h0 and
// dhT may be null (a zero state, a zero gradient); dh0 is always written.
// `scratch` holds ssd_bwd_scratch_floats() floats.  `variant` is the
// wrapper's choice (kernel.variant_bwd): 0 = the five kernels on the fp32
// pipes, the only one.  Returns the launches' cudaError_t as an int.
extern "C" int ssd_bwd(const void* x, const float* dt, const float* A,
                       const void* b, const void* c, const float* h0,
                       const void* dy, const float* dhT, void* dx, float* ddt,
                       float* dA, void* db, void* dc, float* dh0, float* scratch,
                       int batch, int S, int H, int G, int P, int N, int Q,
                       int dtype, int variant, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (variant != kBwdFp32Pipes || scratch == nullptr ||
      !takes(batch, S, H, G, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.x = x; p.dt = dt; p.A = A; p.b = b; p.c = c; p.h0 = h0; p.dy = dy;
  p.dhT = dhT; p.dx = dx; p.ddt = ddt; p.dA = dA; p.db = db; p.dc = dc;
  p.dh0 = dh0;
  p.batch = batch; p.S = S; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q;
  p.nc = (S + Q - 1) / Q;
  p.heads = heads_per_block(H, G);
  p.cum = scratch;
  carve(batch, S, H, G, P, N, Q, &p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
