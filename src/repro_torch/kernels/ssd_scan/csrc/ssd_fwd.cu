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
// bound is bytes.  The kernels that run are fixed by (dtype, P, N, chunk); the
// rule is the wrapper's `kernel.variant()`, which passes its choice in:
//  * bf16 at P = 64, N = 64 or 128, chunk 64, 128 or 256 (the serving paths
//    of mamba2-1.3b, N 128, and zamba2-1.2b, N 64): two kernels on wgmma and
//    TMA, `ssd_state_wgmma` then `ssd_out_wgmma` (see the section below),
//    templated on NA = N / 64, the state's 64-column atoms.  The split writes the bf16 state before each chunk
//    and cum to device memory and reads them back, some 35 MB each way,
//    which puts this design's own floor near 0.07 ms; in exchange C.B^T is
//    computed once per 16 heads of a group, not once per head, and the
//    output blocks are independent of each other (512 at the serving shape).
//  * `ssd_fwd_kernel`, every other case, and the only one for fp32 inputs,
//    which must agree with the plain version to 2e-5, which TF32 would lose:
//    every product in fp32 on the fp32 pipes, 4 x 4 register micro-tiles.
//
// What the design changes against the TPU kernel.  There the chunk index is
// the minor, sequential grid axis and h lives in VMEM scratch between grid
// steps.  Here the fp32 kernel's block owns one (batch, head) and loops over
// the chunks itself, with h [P, N] in shared memory in fp32; the wgmma path's
// state pass does the same with h in registers, and its output pass needs no
// loop over chunks at all.  The [Q, Q] matrix (C.B^T) o L of a chunk of 256
// rows would take 256 KB in fp32, more than a block may have, so it is tiled
// like causal attention without the softmax: row tiles of 64 rows against
// the column tiles at or below the diagonal.  The decay exp(cum_i - cum_j) is
// taken only where j <= i: above the diagonal it overflows, and an inf that
// met a product before the mask would give NaN.  Rows past S load as 0 with
// dt = 0, so they add nothing to y or the state (no padding of the inputs).
// Groups are an index, g = h / (H / G), not a repeat of B and C.
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
constexpr int kMaxChunk = 256;  // rows of cum, dt and the state weights
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kScalars = 3 * kMaxChunk;

// The launches of each CUDA kernel since the library was loaded, counted at
// the launch itself once it succeeded (read through ssd_kernel_launches), so
// a caller can see which kernels a call really ran.
enum SsdKernel { kFwdKernel, kStateWgmma, kOutWgmma, kNumKernels };
const char* const kKernelNames[kNumKernels] = {"ssd_fwd_kernel", "ssd_state_wgmma",
                                               "ssd_out_wgmma"};
long long g_launches[kNumKernels] = {};

cudaError_t counted(cudaError_t e, SsdKernel kernel) {
  if (e == cudaSuccess) ++g_launches[kernel];
  return e;
}

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
  return counted(cudaGetLastError(), kFwdKernel);
}

template <typename Tin>
cudaError_t launch_t(const SsdParams& p, int batch, cudaStream_t stream) {
  // row tiles of 64, or of the whole chunk when it is shorter
  return p.Q >= 64 ? launch<Tin, 64>(p, batch, stream)
                   : launch<Tin, 32>(p, batch, stream);
}

// ---------------------------------------------------------------------------
// bf16 path at the serving shapes (P = 64, N = 64 NA with NA = 1 or 2 atoms
// of 64 state columns, chunk Q of 64, 128 or 256): two kernels on wgmma and
// TMA (hopper_sm90.cuh), one after the other on the stream, splitting the
// work the way the plain version spells it out.  A row of B or C is NA
// 128-byte swizzle atoms; every tile of them, and h_before, is loaded as NA
// boxes of 64 columns, and every product that reduces over N takes 4 NA
// k-steps.
//  (A) `ssd_state_wgmma`, one block per (batch, head), 256 threads; warpgroup
//      wg < NA holds the state's columns 64 wg .. 64 wg + 63 (at N 64 the
//      second warpgroup holds none: it shares the scan and the weighting of
//      x, and the one m64n64 product a k-step does the tensor work that two
//      m64n32 would, without an operand that starts inside a swizzle atom),
//      looping over the chunks: cum = cumsum(dt A) by a warp-parallel scan,
//      written out with dt [B, nc, H, 2, Q] fp32; the state before each chunk written
//      out [B, nc, H, P, N] in bf16 (C.h rounded it to bf16 before as well);
//      then h <- h exp(cum_last) + (x w)^T B with w_j = dt_j exp(cum_last -
//      cum_j), as wgmma with h [P, N] the fp32 accumulator in registers all
//      along.  (x w)^T is the sum of two bf16 parts (hi, lo), so the state
//      that decode starts from keeps some 16 bits of each term, not 8.  x and
//      B arrive by TMA in 64-row sub-tiles through a ring of four stages.
//  (B) `ssd_out_wgmma`, one block per (batch, chunk, 64-row tile i, tile of
//      up to 16 heads that share a group), independent of each other:
//      C_i.B_j^T for the causal column tiles j <= i once per block into
//      shared memory (bf16: the scores are rounded to bf16 for their product
//      anyway), shared by every head of the tile; then for each head
//      y_i = sum_j ((C_i.B_j^T) o exp(cum_i - cum_j) dt_j) x_j
//            + exp(cum_i) C_i.h_before,
//      the first as wgmma with the scores rounded to bf16 in registers (the
//      A operand) and x MN-major from shared memory, the second with C and
//      h_before both from shared memory.  Two consumer warpgroups take
//      alternate heads; a producer warp keeps a ring of three stages (x,
//      h_before, and cum and dt of the head: TMA and one bulk copy) filled,
//      so the next head's copies overlap this head's products.
// Rows past S load as zeros (TMA's out-of-bounds fill) with dt = 0, so they
// add nothing.  Groups are an index.  The decay is taken only where j <= i:
// above the diagonal exp(cum_i - cum_j) overflows.
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 4;  // ring of (A)
constexpr int kLdCB = 72;   // bf16 row stride of a C.B^T tile in (B)

struct SsdTma {
  const float* dt;  // [B, S, H]
  const float* A;   // [H]
  const float* h0;  // [B, H, P, N] or null
  __nv_bfloat16* y; // [B, S, H, P]
  float* hT;        // [B, H, P, N]
  float* cdt;       // [B, nc, H, 2, Q]: cum, then dt; written by (A), read by (B)
  __nv_bfloat16* hb;  // [B, nc, H, P, N], the same
  int batch, S, H, G, Q, nc;
  int heads;        // heads of a block of (B)
};

// a stage of (A)'s ring: x [64][64] and the rows of B, [NA][64][64]
template <int NA>
__host__ __device__ constexpr int state_stage_bytes() {
  return 8192 * (1 + NA);
}

template <int NA>
constexpr size_t state_smem_bytes() {
  // slack; the stages; the lo part of x w; cum, dt and w of a chunk; warp
  // sums; barriers
  return 1024 + kStages * state_stage_bytes<NA>() + 8192 + 3 * 256 * 4 + 8 * 4 +
         kStages * 8;
}

template <int NT, int NA>  // NT = Q / 64 sub-tiles a chunk, NA = N / 64
__global__ void __launch_bounds__(256) ssd_state_wgmma(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tb, SsdTma p) {
  using bf16 = __nv_bfloat16;
  constexpr int Q = NT * 64, N = 64 * NA, kStage = state_stage_bytes<NA>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  // stage s: x at s * kStage, B (NA 64-column atoms) 8 KB after it
  bf16* Xlo = reinterpret_cast<bf16*>(base + kStages * kStage);  // [64][64]
  float* cum = reinterpret_cast<float*>(Xlo + 64 * 64);
  float* dts = cum + 256;
  float* wts = dts + 256;
  float* wsum = wts + 256;  // [8]
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 8);

  const int h = blockIdx.x, b = blockIdx.y;
  const int H = p.H, S = p.S, nc = p.nc;
  const int grp = h / (H / p.G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // warpgroup wg holds the state's columns 64 wg .. 64 wg + 63, if wg < NA
  const int wg = tid / 128, wwarp = warp % 4;
  const bool holds = NA == 2 || warp_index() < 4;
  const int g = lane / 4, qd = lane % 4;
  const int n_units = nc * NT;

  auto stage = [&](int s) { return base + s * kStage; };
  auto issue = [&](int u) {  // sub-tile u of the sequence into stage u % 4
    unsigned char* st = stage(u % kStages);
    const int row = u * 64;  // = chunk * Q + sub-tile * 64
    mbar_expect_tx(full + u % kStages, kStage);
    tma_load_4d(st, &tx, full + u % kStages, 0, h, row, b);
    for (int a = 0; a < NA; ++a)
      tma_load_4d(st + 8192 * (1 + a), &tb, full + u % kStages, 64 * a, grp, row, b);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < min(kStages, n_units); ++u) issue(u);

  // this warpgroup's 64 columns of h [P, N] in the accumulator layout:
  // hacc[i] is (p = 16 wwarp + g + 8 ((i/2)%2), n = 64 wg + 8 (i/4) + 2 qd +
  // i%2)
  float hacc[32];
  const long long st_off = ((long long)b * H + h) * 64 * N;
  auto pos = [&](int i) {
    return (wwarp * 16 + g + 8 * ((i / 2) % 2)) * N + 64 * wg + 8 * (i / 4) + 2 * qd;
  };
  if (holds) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float2 v = make_float2(0.f, 0.f);
      if (p.h0) v = *reinterpret_cast<const float2*>(p.h0 + st_off + pos(i));
      hacc[i] = v.x;
      hacc[i + 1] = v.y;
    }
  }
  const float a = p.A[h];
  // dt of a chunk, 0 past S; loaded one chunk ahead
  auto load_dt = [&](int c) {
    return (tid < min(Q, S - c * Q))
               ? p.dt[((long long)b * S + c * Q + tid) * H + h] : 0.f;
  };
  float d_next = load_dt(0);

  for (int c = 0; c < nc; ++c) {
    // cum = cumsum(dt A): one element a thread, a scan within each warp,
    // then over the warps' sums
    const float d = d_next;
    if (c + 1 < nc) d_next = load_dt(c + 1);
    if (tid < Q) dts[tid] = d;
    const float v = (tid < Q) ? d * a : 0.f;
    float incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += wsum[w];
    if (tid < Q) cum[tid] = incl;
    __syncthreads();
    const float cum_last = cum[Q - 1];
    float* gcdt = p.cdt + (((long long)b * nc + c) * H + h) * 2 * Q;
    if (tid < Q) {
      gcdt[tid] = cum[tid];
      gcdt[Q + tid] = dts[tid];
      wts[tid] = dts[tid] * expf(cum_last - cum[tid]);
    }
    // the state before this chunk, in bf16, then its decay over the chunk
    bf16* hb = p.hb + (((long long)b * nc + c) * H + h) * 64 * N;
    const float decay = expf(cum_last);
    if (holds) {
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        *reinterpret_cast<uint32_t*>(hb + pos(i)) = pack_bf16(hacc[i], hacc[i + 1]);
        hacc[i] *= decay;
        hacc[i + 1] *= decay;
      }
    }
    __syncthreads();  // wts is set

    for (int t = 0; t < NT; ++t) {
      const int u = c * NT + t;
      unsigned char* st = stage(u % kStages);
      mbar_wait(full + u % kStages, (u / kStages) & 1);
      // x w -> hi (in place) and lo, 16 bytes at a time.  The swizzle only
      // permutes 16-byte chunks inside a 128-byte row, so chunk k belongs to
      // row k / 8 and hi and lo keep x's layout.
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
      // h^T += (x w)^T B: A = (x w)^T [P x 64 rows] MN-major, B = this
      // warpgroup's 64 columns of B [64 rows x N] MN-major
      if (holds) {
        fence_regs(hacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = sw128_desc(st + 8192 + wg * 8192 + kk * 2048, 8192, 1024);
          wgmma_ss_n64<1, 1>(hacc, sw128_desc(st + kk * 2048, 8192, 1024), db, 1);
          wgmma_ss_n64<1, 1>(hacc, sw128_desc(reinterpret_cast<unsigned char*>(Xlo) + kk * 2048, 8192, 1024), db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(hacc);
      }
      __syncthreads();  // stage u % 4 and Xlo are free
      if (tid == 0 && u + kStages < n_units) issue(u + kStages);
    }
  }

  if (holds) {
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(p.hT + st_off + pos(i)) = make_float2(hacc[i], hacc[i + 1]);
  }
}

template <int NT, int NA>
struct OutLayout {
  // C [NA][64][64] bf16; C.B^T [NT][64][kLdCB] bf16; a ring of three stages,
  // each x [NT][64][64] + h_before [NA][64][64] bf16 + cum and dt [2][Q]
  // fp32.  The B tiles [NT][NA][64][64] wait in stages 1 and 2 until C.B^T
  // is done.
  static constexpr int kWide = NA * 8192;  // [NA][64][64] bf16: N columns
  static constexpr int kC = kWide;
  static constexpr int kCB = NT * 64 * kLdCB * 2;
  static constexpr int kStage = NT * 8192 + kWide + ((NT * 512 + 1023) / 1024) * 1024;
  static constexpr int kRing = kC + kCB;
  static constexpr size_t kBytes = 1024 + kRing + 3 * kStage + 8 * 24;
  static_assert(kCB % 1024 == 0 && kStage % 1024 == 0, "1,024-byte atoms");
  static_assert(NT * kWide <= 2 * kStage, "B tiles fit in stages 1 and 2");
};

template <int NT, int NA>
__global__ void __launch_bounds__(288, 1) ssd_out_wgmma(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap thb, SsdTma p) {
  using bf16 = __nv_bfloat16;
  using L = OutLayout<NT, NA>;
  constexpr int Q = NT * 64, kWide = L::kWide;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* Cs = base;
  bf16* CB = reinterpret_cast<bf16*>(base + L::kC);
  unsigned char* ring = base + L::kRing;
  unsigned char* Bt = ring + L::kStage;  // until C.B^T is done
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 3 * L::kStage);
  uint64_t* cbar = bars;         // C and the B tiles have landed
  uint64_t* cb_done = bars + 1;  // C.B^T is in shared memory: stages 1, 2 free
  // One barrier per head, used once: a warpgroup takes only every other use
  // of a stage, and a parity wait cannot tell the phase two ahead from the
  // one before.  The stages' releases are counted per stage, in order.
  uint64_t* full = bars + 2;     // [16], head i's copies have landed
  uint64_t* empty = bars + 18;   // [3], stage s is free again

  const int H = p.H, S = p.S, nc = p.nc, HT = p.heads;
  const int n_ht = H / HT;
  // The row tiles of one (batch, chunk, head tile) are neighbours in the grid,
  // longest first, so they run at the same time and share x and h_before in
  // L2: with the row tile the slowest index, each wave of it read them again
  // from device memory (10 % slower in all, PERF.md).
  const int r = NT - 1 - static_cast<int>(blockIdx.x % NT);
  const int rem = blockIdx.x / NT;
  const int ht = rem % n_ht, bc = rem / n_ht;
  const int b = bc / nc, c = bc % nc;
  const int c0 = c * Q, row0 = c0 + r * 64;
  if (row0 >= S) return;  // no valid row: the whole block leaves at once
  const int h_first = ht * HT;
  const int grp = h_first / (H / p.G);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(cbar, 1);
    mbar_init(cb_done, 2);
    for (int i = 0; i < 16; ++i) mbar_init(full + i, 1);
    for (int s = 0; s < 3; ++s) mbar_init(empty + s, 128);  // the user's warpgroup
    mbar_fence_init();
  }
  __syncthreads();

  const int warp_id = warp_index();
  if (warp_id == 8) {
    // the producer warp; one lane issues every copy
    if (tid != 256) return;
    auto issue_head = [&](int i) {  // head h_first + i into stage i % 3
      const int hh = h_first + i;
      unsigned char* st = ring + (i % 3) * L::kStage;
      mbar_expect_tx(full + i, (r + 1) * 8192 + kWide + 2 * Q * 4);
      for (int k = 0; k <= r; ++k)
        tma_load_4d(st + k * 8192, &tx, full + i, 0, hh, c0 + k * 64, b);
      const int hrow = ((b * nc + c) * H + hh) * 64;
      for (int a = 0; a < NA; ++a)
        tma_load_2d(st + NT * 8192 + a * 8192, &thb, full + i, 64 * a, hrow);
      bulk_load(st + NT * 8192 + kWide,
                p.cdt + (((long long)b * nc + c) * H + hh) * 2 * Q, 2 * Q * 4,
                full + i);
    };
    mbar_expect_tx(cbar, (r + 2) * kWide);
    for (int a = 0; a < NA; ++a) {
      tma_load_4d(Cs + a * 8192, &tc, cbar, 64 * a, grp, row0, b);
      for (int k = 0; k <= r; ++k)
        tma_load_4d(Bt + k * kWide + a * 8192, &tb, cbar, 64 * a, grp, c0 + k * 64, b);
    }
    issue_head(0);
    mbar_wait(cb_done, 0);
    for (int i = 1; i < HT; ++i) {
      if (i >= 3) mbar_wait(empty + i % 3, (i / 3 - 1) & 1);
      issue_head(i);
    }
    return;
  }

  const int wg = warp_id / 4, t = tid % 128;
  const int warp = warp_id % 4, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int rA = warp * 16 + g;  // this thread's rows rA and rA + 8 of the tile

  // C.B^T for the column tiles k <= r, warpgroup wg the tiles k = wg, wg + 2;
  // kept in bf16 (the scores are rounded to bf16 for their product anyway)
  {
    constexpr int NK = (NT + 1) / 2;
    float cb[NK][32];
    mbar_wait(cbar, 0);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int k = wg + 2 * j;
      if (k <= r) {
        wgmma_ss_n64_first<0, 0>(cb[j], sw128_desc(Cs, 16, 1024),
                                 sw128_desc(Bt + k * kWide, 16, 1024));
#pragma unroll
        for (int kk = 1; kk < 4 * NA; ++kk) {
          const int off = (kk / 4) * 8192 + (kk % 4) * 32;
          wgmma_ss_n64<0, 0>(cb[j], sw128_desc(Cs + off, 16, 1024),
                             sw128_desc(Bt + k * kWide + off, 16, 1024), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      fence_regs(cb[j]);
      const int k = wg + 2 * j;
      if (k > r) continue;
      bf16* tile = CB + k * 64 * kLdCB;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = rA + 8 * ((e / 2) % 2), col = 8 * (e / 4) + 2 * qd;
        *reinterpret_cast<uint32_t*>(tile + rr * kLdCB + col) =
            pack_bf16(cb[j][e], cb[j][e + 1]);
      }
    }
  }
  named_barrier(1, 256);  // C.B^T is complete; nobody reads the B tiles
  if (t == 0) mbar_arrive(cb_done);

  for (int i = wg; i < HT; i += 2) {
    const int s = i % 3, hh = h_first + i;
    unsigned char* st = ring + s * L::kStage;
    const float* cw = reinterpret_cast<const float*>(st + NT * 8192 + kWide);
    const float* dw = cw + Q;
    mbar_wait(full + i, 0);

    // y_off = C.h_before^T, both from shared memory, in flight while the
    // scores are formed
    float yo[32], yd[32];  // each first k-step overwrites (scale-d 0)
    wgmma_fence();
    wgmma_ss_n64_first<0, 0>(yo, sw128_desc(Cs, 16, 1024),
                             sw128_desc(st + NT * 8192, 16, 1024));
#pragma unroll
    for (int kk = 1; kk < 4 * NA; ++kk) {
      const int off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss_n64<0, 0>(yo, sw128_desc(Cs + off, 16, 1024),
                         sw128_desc(st + NT * 8192 + off, 16, 1024), 1);
    }
    wgmma_commit();
    const float ci[2] = {cw[r * 64 + rA], cw[r * 64 + rA + 8]};

#pragma unroll
    for (int k = 0; k < NT; ++k) {
      if (k > r) continue;
      // scores (C.B^T) o exp(cum_i - cum_j) dt_j for j <= i, else 0, as the
      // bf16 A fragments of the 4 k-steps over this column tile
      const bf16* tile = CB + k * 64 * kLdCB;
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          // register f: row rA + 8 (f % 2), columns 16 kk + 8 (f / 2) + 2 qd, +1
          const int rr = rA + 8 * (f % 2), col = 16 * kk + 8 * (f / 2) + 2 * qd;
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(tile + rr * kLdCB + col);
          const int jj = k * 64 + col, ii = r * 64 + rr;
          const float c_i = ci[f % 2];
          const float s0 = (jj <= ii) ? __low2float(v) *
                                            fast_exp2((c_i - cw[jj]) * kLog2e) * dw[jj]
                                      : 0.f;
          const float s1 = (jj + 1 <= ii) ? __high2float(v) *
                                                fast_exp2((c_i - cw[jj + 1]) * kLog2e) *
                                                dw[jj + 1]
                                          : 0.f;
          sa[kk][f] = pack_bf16(s0, s1);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n64<1>(yd, sa[kk], sw128_desc(st + k * 8192 + kk * 2048, 8192, 1024),
                        k > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();  // sa is rewritten by the next column tile
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);  // live until read
    }
    wgmma_wait<0>();
    fence_regs(yo);
    fence_regs(yd);
    const float e_i[2] = {expf(ci[0]), expf(ci[1])};
    mbar_arrive(empty + s);  // every read of the stage is done

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + rA + 8 * half;
      if (row >= S) continue;
      bf16* yrow = p.y + ((long long)b * S + row) * H * 64 + (long long)hh * 64 + 2 * qd;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const int e = 4 * nn + 2 * half;
        *reinterpret_cast<uint32_t*>(yrow + nn * 8) =
            pack_bf16(yd[e] + e_i[half] * yo[e], yd[e + 1] + e_i[half] * yo[e + 1]);
      }
    }
  }
}

// x [B, S, H, 64] and B, C [B, S, G, N] as 4-D maps (columns, head or
// group, sequence, batch), boxes of 64 columns x 64 rows (a row of B or C is
// N / 64 boxes); h_before [B nc H 64, N] as a 2-D map, boxes of 64 x 64.
bool ssd_maps(const SsdTma& p, int N, const void* x, const void* bm, const void* cm,
              CUtensorMap* tx, CUtensorMap* tb, CUtensorMap* tc,
              CUtensorMap* thb) {
  const cuuint32_t box4[4] = {64, 1, 64, 1}, box2[2] = {64, 64};
  const cuuint64_t B = p.batch, S = p.S, H = p.H, G = p.G, n = N;
  const cuuint64_t dx[4] = {64, H, S, B};
  const cuuint64_t sx[3] = {64 * 2, H * 64 * 2, S * H * 64 * 2};
  const cuuint64_t dbc[4] = {n, G, S, B};
  const cuuint64_t sbc[3] = {n * 2, G * n * 2, S * G * n * 2};
  const cuuint64_t dh[2] = {n, B * p.nc * H * 64};
  const cuuint64_t sh[1] = {n * 2};
  return make_map_bf16(tx, x, 4, dx, sx, box4) &&
         make_map_bf16(tb, bm, 4, dbc, sbc, box4) &&
         make_map_bf16(tc, cm, 4, dbc, sbc, box4) &&
         make_map_bf16(thb, p.hb, 2, dh, sh, box2);
}

template <int NT, int NA>
cudaError_t launch_wgmma(const SsdTma& p, const void* x, const void* bm,
                         const void* cm, cudaStream_t stream) {
  constexpr size_t smem_a = state_smem_bytes<NA>(), smem_b = OutLayout<NT, NA>::kBytes;
  static const cudaError_t attr_a = cudaFuncSetAttribute(
      ssd_state_wgmma<NT, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  static const cudaError_t attr_b = cudaFuncSetAttribute(
      ssd_out_wgmma<NT, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_b));
  if (attr_a != cudaSuccess) return attr_a;
  if (attr_b != cudaSuccess) return attr_b;
  CUtensorMap tx, tb, tc, thb;
  if (!ssd_maps(p, 64 * NA, x, bm, cm, &tx, &tb, &tc, &thb)) return cudaErrorInvalidValue;
  ssd_state_wgmma<NT, NA><<<dim3(p.H, p.batch), 256, smem_a, stream>>>(tx, tb, p);
  const cudaError_t e = counted(cudaGetLastError(), kStateWgmma);
  if (e != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(NT) * p.batch * p.nc * (p.H / p.heads);
  ssd_out_wgmma<NT, NA><<<grid, 288, smem_b, stream>>>(tx, tb, tc, thb, p);
  return counted(cudaGetLastError(), kOutWgmma);
}

template <int NA>
cudaError_t launch_wgmma_q(const SsdTma& p, const void* x, const void* bm,
                           const void* cm, cudaStream_t stream) {
  switch (p.Q) {
    case 64: return launch_wgmma<1, NA>(p, x, bm, cm, stream);
    case 128: return launch_wgmma<2, NA>(p, x, bm, cm, stream);
    default: return launch_wgmma<4, NA>(p, x, bm, cm, stream);
  }
}

// The codes of kernel.VARIANT_CODES (a test holds the two to each other); the
// wrapper's variant() chooses.
enum SsdVariant {
  kFp32Pipes = 0,  // ssd_fwd_kernel
  kWgmma = 1,      // ssd_wgmma
};

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A and the states are
// float32.  Every tensor is contiguous.  h0 may be null (a zero state).  The
// wrapper checks the sizes: chunk Q in {32, 64, 128, 256}, P a multiple of 4
// up to 64, N a multiple of 4 up to 128, H a multiple of G.  `variant` is the
// wrapper's choice, by (dtype, P, N, Q) alone: 0 = `ssd_fwd_kernel` on the
// fp32 pipes; 1 = the two wgmma kernels, which take only bf16 at P = 64, N =
// 64 or 128, Q >= 64 and need the scratch `cdt` [B, nc, H, 2, Q] fp32 and
// `hb` [B, nc, H, P, N] bf16 and TMA-aligned tensors (16-byte bases; the
// wrapper checks).  Returns the launches' cudaError_t as an int (cudaErrorInvalidValue
// for a variant that cannot take these inputs).
extern "C" int ssd_fwd(const void* x, const float* dt, const float* A,
                       const void* b, const void* c, const float* h0, void* y,
                       float* hT, float* cdt, void* hb, int batch, int S, int H,
                       int G, int P, int N, int Q, int dtype, int variant,
                       void* stream) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (variant != kFp32Pipes && variant != kWgmma)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q != 32 && Q != 64 && Q != 128 && Q != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P % 4 || P > kMaxP || N % 4 || N > kMaxN || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != 1 || P != 64 || (N != 64 && N != 128) || Q < 64 || cdt == nullptr ||
        hb == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    // heads a block of the output pass serves, sharing C.B^T: the largest of
    // 16, 8, 4, 2, 1 that divides the heads of a group
    int heads = 16;
    while ((H / G) % heads) heads /= 2;
    SsdTma t;
    t.dt = dt; t.A = A; t.h0 = h0; t.y = static_cast<__nv_bfloat16*>(y);
    t.hT = hT; t.cdt = cdt; t.hb = static_cast<__nv_bfloat16*>(hb);
    t.batch = batch; t.S = S; t.H = H; t.G = G; t.Q = Q;
    t.nc = (S + Q - 1) / Q; t.heads = heads;
    return static_cast<int>(N == 64 ? launch_wgmma_q<1>(t, x, b, c, s)
                                    : launch_wgmma_q<2>(t, x, b, c, s));
  }
  SsdParams p;
  p.x = x; p.dt = dt; p.A = A; p.b = b; p.c = c; p.h0 = h0; p.y = y; p.hT = hT;
  p.S = S; p.H = H; p.G = G; p.P = P; p.N = N; p.Q = Q;
  return static_cast<int>(dtype ? launch_t<__nv_bfloat16>(p, batch, s)
                                : launch_t<float>(p, batch, s));
}

// The library's CUDA kernels by index (null past the last), and the launches
// of each since the library was loaded.
extern "C" const char* ssd_kernel_name(int i) {
  return (i >= 0 && i < kNumKernels) ? kKernelNames[i] : nullptr;
}
extern "C" long long ssd_kernel_launches(int i) {
  return (i >= 0 && i < kNumKernels) ? g_launches[i] : -1;
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
