// Mamba-2 SSD chunked scan, forward, for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel `_ssd_kernel` of src/repro/kernels/ssd_scan/kernel.py
// (launched by `ssd_scan`, public wrapper `ops.ssd`), and computes what the
// model's `ssd_chunked` computes, which the TPU kernel does not: it takes an
// optional initial state and returns the final state beside y.  For
// x [B,S,H,P], dt [B,S,H], A [H], B, C [B,S,G,N] it evaluates the recurrence
//     h_t = h_{t-1} * exp(dt_t * A) + dt_t * B_t (x) x_t,   y_t = C_t . h_t
// chunk by chunk in the dual form of arXiv:2405.21060 section 6: with
// cum = cumsum(dt * A) inside a chunk,
//     y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . h_before
//     h   = h_before exp(cum_last) + sum_j dt_j exp(cum_last - cum_j) x_j (x) B_j
//
// What bounds it on this card.  Each input is read once and y and the state
// are written once: at the serving shape (x [8,1024,64,64] bf16, N = 128,
// chunk 256) that is about 157 MB, 0.047 ms at 3.35 TB/s, against some 30
// GFLOP that the algorithm needs, 0.03 ms at the bf16 tensor-core peak: the
// bound is bytes.  Two kernels do the work, and neither is near that bound,
// because each block recomputes C.B^T for its own head (the 64 heads of a
// group share it) and re-reads the column tiles of a chunk for every row tile:
// they are bound by operations and by traffic between L2 and shared memory.
//  * `ssd_fwd_mma`, the serving path (bf16, P = 64, N = 128, chunk >= 64):
//    all four products on the tensor cores (mma.sync, fp32 accumulate), the
//    scores kept in registers between C.B^T and their product with x, as
//    attention keeps its probabilities (flash_fwd.cu).
//  * `ssd_fwd_kernel`, every other case, and the only one for fp32 inputs,
//    which must agree with the plain version to 2e-5, which TF32 would lose:
//    every product in fp32 on the fp32 pipes, 4 x 4 register micro-tiles.
// Sharing C.B^T across the heads of a group, `wgmma`, TMA and a three-phase
// split are later work (PERF.md).
//
// What the design changes against the TPU kernel.  There the chunk index is
// the minor, sequential grid axis and h lives in VMEM scratch between grid
// steps.  Here one block owns one (batch, head) and loops over the chunks
// itself, with h [P, N] in shared memory in fp32.  The [Q, Q] matrix
// (C.B^T) o L of a chunk of 256 rows would take 256 KB in fp32, more than a
// block may have, so it is tiled like causal attention without the softmax:
// row tiles of T rows against the column tiles at or below the diagonal, one
// [T, T] tile at a time.  The decay exp(cum_i - cum_j) is taken only where
// j <= i: above the diagonal it overflows, and an inf that met a product
// before the mask would give NaN.  Rows past S load as 0 with dt = 0, so they
// add nothing to y or the state (no padding of the inputs).  Groups are an
// index, g = h / (H / G), not a repeat of B and C.
//
// The C interface at the end returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;  // rows of cum, dt and the state weights
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kScalars = 3 * kMaxChunk;

struct SsdParams {
  const void* x;    // [B, S, H, P], fp32 or bf16, contiguous
  const float* dt;  // [B, S, H]
  const float* A;   // [H]
  const void* b;    // [B, S, G, N], the type of x
  const void* c;    // [B, S, G, N], the type of x
  const float* h0;  // [B, H, P, N], or null for a zero state
  void* y;          // [B, S, H, P], the type of x
  float* hT;        // [B, H, P, N]
  int S, H, G, P, N, Q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// Row stride in shared memory of a tile with `cols` columns of type Tin: odd
// for fp32 and 2 mod 4 for bf16, so the rows that the lanes of a warp read at
// one column fall into distinct banks.
template <typename Tin>
__host__ __device__ __forceinline__ int tile_ld(int cols) {
  return cols + (sizeof(Tin) == 2 ? 2 : 1);
}

template <typename Tin>
__host__ __device__ __forceinline__ size_t smem_bytes(int T, int P, int N) {
  return sizeof(float) * (kScalars + P * (N + 1) + T * (T + 1)) +
         sizeof(Tin) * (2 * T * tile_ld<Tin>(N) + T * tile_ld<Tin>(P));
}

// Rows [row0, row0 + T) of a chunk-local [rows, cols] slab with row stride
// `ld_g` into shared memory with row stride `ld_s`; rows at or beyond
// `valid` are zero.
template <typename Tin, int T>
__device__ __forceinline__ void load_tile(Tin* dst, int ld_s, const Tin* src,
                                          long long ld_g, int row0, int valid,
                                          int cols) {
  for (int i = threadIdx.x; i < T * cols; i += kThreads) {
    const int r = i / cols, col = i % cols;
    const int row = row0 + r;
    dst[r * ld_s + col] =
        row < valid ? src[row * ld_g + col] : static_cast<Tin>(0.f);
  }
}

// ---------------------------------------------------------------------------
// fp32 pipes: fp32 or bf16 inputs, any P and N the wrapper takes.  256
// threads; thread tiles of 4 x 4 outputs with their columns interleaved.
// ---------------------------------------------------------------------------

template <typename Tin, int T>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_kernel(SsdParams p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = p.S, H = p.H, P = p.P, N = p.N, Q = p.Q;
  const int g = h / (H / p.G);
  const int tid = threadIdx.x;
  const int LDH = N + 1, LDS = T + 1;
  const int LDN = tile_ld<Tin>(N), LDP = tile_ld<Tin>(P);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [Q] cumsum(dt * A)
  float* dts = cum + kMaxChunk;                     // [Q] dt, 0 past S
  float* wts = dts + kMaxChunk;                     // [Q] state weights
  float* Hs = cum + kScalars;                       // [P][LDH] the state
  float* Ss = Hs + P * LDH;                         // [T][LDS] scores
  Tin* Cs = reinterpret_cast<Tin*>(Ss + T * LDS);   // [T][LDN] C, row tile
  Tin* Bs = Cs + T * LDN;                           // [T][LDN] B, col tile
  Tin* Xs = Bs + T * LDN;                           // [T][LDP] x, col tile

  const Tin* xg = static_cast<const Tin*>(p.x) + ((long long)b * S * H + h) * P;
  const Tin* bg = static_cast<const Tin*>(p.b) + ((long long)b * S * p.G + g) * N;
  const Tin* cg = static_cast<const Tin*>(p.c) + ((long long)b * S * p.G + g) * N;
  const float* dtg = p.dt + (long long)b * S * H + h;
  Tin* yg = static_cast<Tin*>(p.y) + ((long long)b * S * H + h) * P;
  const long long ld_x = (long long)H * P, ld_bc = (long long)p.G * N;
  const long long st_off = ((long long)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    Hs[(i / N) * LDH + i % N] = p.h0 ? p.h0[st_off + i] : 0.f;
  const float a = p.A[h];

  // Thread tiles.  y [T, P] and the scores [T, T]: 4 rows x 4 columns
  // (columns interleaved, so neighbouring lanes read neighbouring rows of the
  // right-hand operand).  At most one tile a thread: T * P <= 64 * 64 = 4096.
  const int ycols = P / 4;
  const bool y_owner = tid < (T / 4) * ycols;
  const int ym = tid / ycols, yn = tid % ycols;
  constexpr int scols = T / 4;
  const bool s_owner = tid < (T / 4) * scols;
  const int sm = tid / scols, sn = tid % scols;
  const int hcols = N / 4;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * Q;
    const int rows = min(Q, S - c0);
    const Tin* xc = xg + c0 * ld_x;
    const Tin* bc = bg + c0 * ld_bc;
    const Tin* cc = cg + c0 * ld_bc;
    __syncthreads();  // the previous chunk no longer reads cum, dts, wts, Hs

    // dt (0 past S), and the inclusive cumulative sum of dt * A taken in
    // order by one thread: the plain version sums in order too, so cum is the
    // same to the bit.  At chunk 256 cum reaches some -200, where one ulp is
    // 1.5e-5: a tree-ordered sum would differ by that in the exponent of a
    // decay, which is most of the 2e-5 agreement the fp32 path must hold.
    if (tid < Q) dts[tid] = tid < rows ? dtg[(long long)(c0 + tid) * H] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int i = 0; i < Q; ++i) {
        v += dts[i] * a;
        cum[i] = v;
      }
    }
    __syncthreads();

    const int n_tiles = (rows + T - 1) / T;  // tiles that hold a valid row
    for (int r = 0; r < n_tiles; ++r) {
      const int r0 = r * T;
      __syncthreads();  // the previous row tile no longer reads Cs
      load_tile<Tin, T>(Cs, LDN, cc, ld_bc, r0, rows, N);
      __syncthreads();

      // y = exp(cum_i) * C_i . h_before, then the diagonal part below
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (y_owner) {
        for (int n = 0; n < N; ++n) {
          float cv[4], hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = to_f32(Cs[(ym * 4 + i) * LDN + n]);
#pragma unroll
          for (int j = 0; j < 4; ++j) hv[j] = Hs[(yn + j * ycols) * LDH + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = expf(cum[r0 + ym * 4 + i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] *= e;
        }
      }

      for (int k = 0; k <= r; ++k) {
        const int k0 = k * T;
        __syncthreads();  // the previous column tile no longer reads Bs, Xs, Ss
        load_tile<Tin, T>(Bs, LDN, bc, ld_bc, k0, rows, N);
        load_tile<Tin, T>(Xs, LDP, xc, ld_x, k0, rows, P);
        __syncthreads();

        // scores: (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
        if (s_owner) {
          float s[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = to_f32(Cs[(sm * 4 + i) * LDN + n]);
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = to_f32(Bs[(sn + j * scols) * LDN + n]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qi = r0 + sm * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int qj = k0 + sn + j * scols;
              // mask first: exp(cum_i - cum_j) overflows above the diagonal
              float val = 0.f;
              if (qj <= qi) val = s[i][j] * expf(cum[qi] - cum[qj]) * dts[qj];
              Ss[(sm * 4 + i) * LDS + sn + j * scols] = val;
            }
          }
        }
        __syncthreads();

        if (y_owner) {
          for (int j = 0; j < T; ++j) {
            float sv[4], xv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) sv[i] = Ss[(ym * 4 + i) * LDS + j];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) xv[jj] = to_f32(Xs[j * LDP + yn + jj * ycols]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(sv[i], xv[jj], acc[i][jj]);
          }
        }
      }

      if (y_owner) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + ym * 4 + i;
          if (row >= rows) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            store_out(yg + (c0 + row) * ld_x + yn + j * ycols, acc[i][j]);
        }
      }
    }

    // the state after the chunk; every row tile has read Hs by the barrier
    // at the top of the loop below
    const float cum_last = cum[Q - 1];  // rows past S add 0 to cum
    const float decay = expf(cum_last);
    if (tid < Q) wts[tid] = dts[tid] * expf(cum_last - cum[tid]);
    for (int k = 0; k < n_tiles; ++k) {
      const int k0 = k * T;
      __syncthreads();  // Bs and Xs are free, Hs is read by nobody, wts is set
      load_tile<Tin, T>(Bs, LDN, bc, ld_bc, k0, rows, N);
      load_tile<Tin, T>(Xs, LDP, xc, ld_x, k0, rows, P);
      __syncthreads();
      for (int t = tid; t < (P / 4) * hcols; t += kThreads) {
        const int hm = t / hcols, hn = t % hcols;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int j = 0; j < T; ++j) {
          const float w = wts[k0 + j];
          float xv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = to_f32(Xs[j * LDP + hm * 4 + i]) * w;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = to_f32(Bs[j * LDN + hn + jj * hcols]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(xv[i], bv[jj], acc[i][jj]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float* hp = &Hs[(hm * 4 + i) * LDH + hn + jj * hcols];
            *hp = (k == 0 ? *hp * decay : *hp) + acc[i][jj];
          }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    p.hT[st_off + i] = Hs[(i / N) * LDH + i % N];
}

template <typename Tin, int T>
cudaError_t launch(const SsdParams& p, int batch, cudaStream_t stream) {
  // More than 48 KB of dynamic shared memory has to be asked for, once for
  // each instance, for the largest P and N it takes.
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_fwd_kernel<Tin, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<Tin>(T, kMaxP, kMaxN)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.H, batch);
  ssd_fwd_kernel<Tin, T><<<grid, kThreads, smem_bytes<Tin>(T, p.P, p.N), stream>>>(p);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_t(const SsdParams& p, int batch, cudaStream_t stream) {
  // row tiles of 64, or of the whole chunk when it is shorter
  return p.Q >= 64 ? launch<Tin, 64>(p, batch, stream)
                   : launch<Tin, 32>(p, batch, stream);
}

// ---------------------------------------------------------------------------
// bf16 path at the serving shape (P = 64, N = 128, chunk >= 64): the four
// products on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// accumulate).  C.B^T takes bf16 inputs as they are; the scores and the state
// (for C.h) are rounded to bf16 before their product, x * dt * decay (for the
// state update) is split into two bf16 parts; every sum stays fp32, as does
// the state between chunks.  128 threads = 4 warps: in the y products warp w owns rows
// w*16 .. w*16+15 of the 64-row tile, in the state update rows w*16 ..
// w*16+15 of P.  Fragment layouts as in flash_fwd.cu: g = lane / 4,
// t = lane % 4; A (16x16): a0 (row g, k 2t..), a1 (row g+8), a2 (row g,
// k 8+2t..), a3 (row g+8, k 8+2t..); B (16x8): b0 (k 2t.., col g), b1 (k
// 8+2t..); C (16x8): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int P, int N>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  // cum, dts, wts; the fp32 state [P][N+4]; its bf16 copy [P][N+8]; the C and
  // B tiles [64][N+8]; the x tile [64][P+8]
  return sizeof(float) * (kScalars + P * (N + 4)) +
         sizeof(__nv_bfloat16) * ((P + 128) * (N + 8) + 64 * (P + 8));
}

template <int P, int N>
__global__ void __launch_bounds__(128, 2) ssd_fwd_mma(SsdParams p) {
  constexpr int T = 64;
  // +8 bf16 (16 bytes) of padding: the 8 rows one ldmatrix phase touches
  // fall into distinct banks and rows stay 16-byte aligned
  constexpr int LDN = N + 8, LDP = P + 8, LDH = N + 4;
  constexpr int KN = N / 16;  // k-steps over N
  constexpr int NP = P / 8;   // n-tiles over P
  constexpr int NT = T / 8;   // n-tiles over a column tile
  constexpr int NN = N / 8;   // n-tiles over N
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);
  float* dts = cum + kMaxChunk;
  float* wts = dts + kMaxChunk;
  float* Hs = cum + kScalars;                                     // [P][LDH]
  __nv_bfloat16* Hb = reinterpret_cast<__nv_bfloat16*>(Hs + P * LDH);  // [P][LDN]
  __nv_bfloat16* Cs = Hb + P * LDN;                               // [T][LDN]
  __nv_bfloat16* Bs = Cs + T * LDN;                               // [T][LDN]
  __nv_bfloat16* Xs = Bs + T * LDN;                               // [T][LDP]
  __nv_bfloat16* Xl = Cs;  // [T][LDP], in the state update only

  const int h = blockIdx.x, b = blockIdx.y;
  const int S = p.S, H = p.H, Q = p.Q;
  const int grp = h / (H / p.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  using bf16 = __nv_bfloat16;
  const bf16* xg = static_cast<const bf16*>(p.x) + ((long long)b * S * H + h) * P;
  const bf16* bg = static_cast<const bf16*>(p.b) + ((long long)b * S * p.G + grp) * N;
  const bf16* cg = static_cast<const bf16*>(p.c) + ((long long)b * S * p.G + grp) * N;
  const float* dtg = p.dt + (long long)b * S * H + h;
  bf16* yg = static_cast<bf16*>(p.y) + ((long long)b * S * H + h) * P;
  const long long ld_x = (long long)H * P, ld_bc = (long long)p.G * N;
  const long long st_off = ((long long)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += 128) {
    const float v = p.h0 ? p.h0[st_off + i] : 0.f;
    Hs[(i / N) * LDH + i % N] = v;
    Hb[(i / N) * LDN + i % N] = __float2bfloat16(v);
  }
  const float a = p.A[h];

  const int n_chunks = (S + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * Q;
    const int rows = min(Q, S - c0);
    const bf16* xc = xg + c0 * ld_x;
    const bf16* bc = bg + c0 * ld_bc;
    const bf16* cc = cg + c0 * ld_bc;
    __syncthreads();  // the previous chunk no longer reads cum, dts, wts, Hb

    // dt and cumsum(dt * A), summed in order (see the fp32 kernel)
    for (int i = tid; i < Q; i += 128)
      dts[i] = i < rows ? dtg[(long long)(c0 + i) * H] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
      for (int i = 0; i < Q; ++i) {
        v += dts[i] * a;
        cum[i] = v;
      }
    }

    const int n_tiles = (rows + T - 1) / T;
    for (int r = 0; r < n_tiles; ++r) {
      const int r0 = r * T;
      __syncthreads();  // Cs is free; cum is set
      load_tile_async<T, N, LDN>(Cs, cc, ld_bc, r0, rows, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // A fragments of this warp's 16 rows of C, for every k-step over N
      uint32_t cf[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldmatrix_x4(cf[kk], Cs + (warp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LDN +
                                kk * 16 + 8 * (lane / 16));

      // y = exp(cum_i) * C_i . h, h from its bf16 copy; B fragments of h^T
      // as K^T in flash_fwd.cu: one ldmatrix.x4 gives n-tiles 2np, 2np + 1
      float acc[NP][4];
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
        for (int np = 0; np < NP / 2; ++np) {
          uint32_t rr[4];
          ldmatrix_x4(rr, Hb + ((2 * np + lane / 16) * 8 + lane % 8) * LDN +
                              kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16_16816(acc[2 * np], cf[kk], rr[0], rr[1]);
          mma_bf16_16816(acc[2 * np + 1], cf[kk], rr[2], rr[3]);
        }
      }
      const int qi0 = r0 + warp * 16 + g, qi1 = qi0 + 8;
      const float cum_i0 = cum[qi0], cum_i1 = cum[qi1];
      const float e0 = expf(cum_i0), e1 = expf(cum_i1);
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }

      for (int k = 0; k <= r; ++k) {
        const int k0 = k * T;
        __syncthreads();  // Bs and Xs are free
        load_tile_async<T, N, LDN>(Bs, bc, ld_bc, k0, rows, tid);
        load_tile_async<T, P, LDP>(Xs, xc, ld_x, k0, rows, tid);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        // scores C_i . B_j for this warp's 16 rows and the tile's 64 columns
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t rr[4];
            ldmatrix_x4(rr, Bs + ((2 * np + lane / 16) * 8 + lane % 8) * LDN +
                                kk * 16 + ((lane / 8) % 2) * 8);
            mma_bf16_16816(s[2 * np], cf[kk], rr[0], rr[1]);
            mma_bf16_16816(s[2 * np + 1], cf[kk], rr[2], rr[3]);
          }
        }
        // mask first (exp(cum_i - cum_j) overflows above the diagonal), then
        // the decay and dt_j
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qj = k0 + n * 8 + 2 * t + (e & 1);
            const int qi = (e >> 1) ? qi1 : qi0;
            const float ci = (e >> 1) ? cum_i1 : cum_i0;
            s[n][e] = qj <= qi ? s[n][e] * fast_exp2((ci - cum[qj]) * kLog2e) *
                                     dts[qj]
                               : 0.f;
          }
        }
        // y += S x: the C fragments of two neighbouring score n-tiles are the
        // A fragment of one 16-wide k-step; B fragments of x come transposed
        // out of shared memory, as V in flash_fwd.cu
#pragma unroll
        for (int kk = 0; kk < T / 16; ++kk) {
          uint32_t af[4];
          af[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
          af[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
          af[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          af[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int nd = 0; nd < P / 16; ++nd) {
            uint32_t rr[4];
            ldmatrix_x4_trans(rr, Xs + (kk * 16 + lane % 16) * LDP + nd * 16 +
                                      (lane / 16) * 8);
            mma_bf16_16816(acc[2 * nd], af, rr[0], rr[1]);
            mma_bf16_16816(acc[2 * nd + 1], af, rr[2], rr[3]);
          }
        }
      }

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? qi1 : qi0;
        if (row >= rows) continue;
        bf16* yrow = yg + (c0 + row) * ld_x + 2 * t;
#pragma unroll
        for (int n = 0; n < NP; ++n)
          *reinterpret_cast<uint32_t*>(yrow + n * 8) =
              pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
      }
    }

    // the state after the chunk: h^T = h^T decay + (x w)^T B over the chunk,
    // each warp its 16 rows of P, fp32 in registers
    const float cum_last = cum[Q - 1];
    const float decay = expf(cum_last);
    for (int i = tid; i < Q; i += 128) wts[i] = dts[i] * expf(cum_last - cum[i]);
    const int pr0 = warp * 16 + g, pr1 = pr0 + 8;
    float hacc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t;
      hacc[n][0] = Hs[pr0 * LDH + col] * decay;
      hacc[n][1] = Hs[pr0 * LDH + col + 1] * decay;
      hacc[n][2] = Hs[pr1 * LDH + col] * decay;
      hacc[n][3] = Hs[pr1 * LDH + col + 1] * decay;
    }
    for (int k = 0; k < n_tiles; ++k) {
      const int k0 = k * T;
      __syncthreads();  // Bs and Xs are free; wts is set
      load_tile_async<T, N, LDN>(Bs, bc, ld_bc, k0, rows, tid);
      cp_async_commit();
      // x w as the sum of two bf16 numbers (hi, and lo in the C tile's
      // space, which the state update does not use): the state that decode
      // starts from keeps some 16 bits of each term, not 8
      for (int i = tid; i < T * P; i += 128) {
        const int j = i / P, col = i % P, row = k0 + j;
        const float v = row < rows ? __bfloat162float(xc[row * ld_x + col]) * wts[row] : 0.f;
        const bf16 hi = __float2bfloat16(v);
        Xs[j * LDP + col] = hi;
        Xl[j * LDP + col] = __float2bfloat16(v - __bfloat162float(hi));
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) {
        // A = (x w)^T: ldmatrix.trans of the [j][p] tile; matrix m = lane / 8
        // is (p half m % 2, j half m / 2)
        const int off = (kk * 16 + ((lane / 8) / 2) * 8 + lane % 8) * LDP +
                        warp * 16 + ((lane / 8) % 2) * 8;
        uint32_t ahi[4], alo[4];
        ldmatrix_x4_trans(ahi, Xs + off);
        ldmatrix_x4_trans(alo, Xl + off);
#pragma unroll
        for (int nd = 0; nd < N / 16; ++nd) {
          uint32_t rr[4];
          ldmatrix_x4_trans(rr, Bs + (kk * 16 + lane % 16) * LDN + nd * 16 +
                                    (lane / 16) * 8);
          mma_bf16_16816(hacc[2 * nd], ahi, rr[0], rr[1]);
          mma_bf16_16816(hacc[2 * nd + 1], ahi, rr[2], rr[3]);
          mma_bf16_16816(hacc[2 * nd], alo, rr[0], rr[1]);
          mma_bf16_16816(hacc[2 * nd + 1], alo, rr[2], rr[3]);
        }
      }
    }
    // every warp is past the first barrier above, so none reads Hb any more;
    // each warp writes back only its own rows
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int col = n * 8 + 2 * t;
      Hs[pr0 * LDH + col] = hacc[n][0];
      Hs[pr0 * LDH + col + 1] = hacc[n][1];
      Hs[pr1 * LDH + col] = hacc[n][2];
      Hs[pr1 * LDH + col + 1] = hacc[n][3];
      *reinterpret_cast<uint32_t*>(Hb + pr0 * LDN + col) = pack_bf16(hacc[n][0], hacc[n][1]);
      *reinterpret_cast<uint32_t*>(Hb + pr1 * LDN + col) = pack_bf16(hacc[n][2], hacc[n][3]);
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += 128)
    p.hT[st_off + i] = Hs[(i / N) * LDH + i % N];
}

template <int P, int N>
cudaError_t launch_mma(const SsdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<P, N>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_fwd_mma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.H, batch);
  ssd_fwd_mma<P, N><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A and the states are
// float32.  Every tensor is contiguous.  h0 may be null (a zero state).  The
// wrapper checks the sizes: chunk Q in {32, 64, 128, 256}, P a multiple of 4
// up to 64, N a multiple of 4 up to 128, H a multiple of G.  bf16 at P = 64,
// N = 128, Q >= 64 with x, B, C and y on 16-byte boundaries runs on the
// tensor cores, everything else on the fp32 pipes.  Returns the launch's
// cudaError_t as an int.
extern "C" int ssd_fwd(const void* x, const float* dt, const float* A,
                       const void* b, const void* c, const float* h0, void* y,
                       float* hT, int batch, int S, int H, int G, int P, int N,
                       int Q, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (Q != 32 && Q != 64 && Q != 128 && Q != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P % 4 || P > kMaxP || N % 4 || N > kMaxN || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdParams p;
  p.x = x; p.dt = dt; p.A = A; p.b = b; p.c = c; p.h0 = h0; p.y = y; p.hT = hT;
  p.S = S; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && P == 64 && N == 128 && Q >= 64 && aligned16(x) &&
      aligned16(b) && aligned16(c) && aligned16(y))
    return static_cast<int>(launch_mma<64, 128>(p, batch, s));
  return static_cast<int>(dtype ? launch_t<__nv_bfloat16>(p, batch, s)
                                : launch_t<float>(p, batch, s));
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
