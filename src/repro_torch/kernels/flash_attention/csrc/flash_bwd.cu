// Flash-attention backward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the blocked backward of the JAX package's flash attention,
// `_flash_bwd_impl` in src/repro/models/flash.py (behind the custom VJP of
// `flash_attention` there; the TPU forward `_fa_kernel` of
// src/repro/kernels/flash_attention/kernel.py has no Pallas backward).  Given
// q [B,Hq,Sq,D], k, v [B,Hkv,Skv,D], the forward's output o and its per-row
// log-sum-exp lse [B,Hq,Sq] (flash_fwd.cu writes it), and dO, it computes
//   delta = rowsum(dO * O)
//   P     = exp(S / sqrt(D) - lse) under the mask     (S = Q K^T)
//   dP    = dO V^T
//   dS    = P * (dP - delta) / sqrt(D)
//   dQ    = dS K,   dK = dS^T Q,   dV = P^T dO
// with dK and dV summed over the Hq / Hkv query heads of each KV head.  The
// masks are the forward's: causal, sliding window, ragged Sq and Skv; a row
// that sees no key has P = 0 everywhere, so it gets zero gradient and gives
// none, whatever its lse.
//
// What bounds it on this card.  Five products over the visible pairs, two
// and a half times the forward's operations, against each input read once:
// at a training shape (Sq = Skv = 1024, D = 64) it is bound by operations.
// Three CUDA kernels a call, each in two precisions (the wrapper's
// `kernel.variant_bwd()` chooses, and passes its code in):
//  * `fa_bwd_delta`: delta, one warp a row, fp32.
//  * `fa_bwd_dkdv_*`: one block per (batch, KV head, 64-row k tile).  It
//    loops over the q tiles of every query head of the group, so dK and dV
//    are summed in registers, without atomics; the loop bounds are the
//    forward's seen from the key's side (causal: from the diagonal tile on;
//    window: up to the last query that still sees the tile).
//  * `fa_bwd_dq_*`: one block per (batch, query head, 64-row q tile),
//    looping over the k tiles in the forward's bounds.  No atomics either, so
//    a result is the same from run to run.
// `*_simt` (fp32) computes in full fp32 on the fp32 pipes, thread micro-tiles
// of 4 x 4 as in the forward's fp32 kernel.  `*_mma` (bf16) runs every
// product on `mma.sync.m16n8k16` with fp32 accumulation, operands through
// `ldmatrix` from shared memory, the next tile's copy by `cp.async` while
// this one is computed on; P and dS are rounded to bf16 as the A operands of
// the second products.  S and dP are computed twice (once in each of the two
// kernels): seven products for the five, the price of no atomics in a first
// kernel.  `wgmma` and TMA are a later step.
//
// What the design changes against the JAX function.  There one scan over q
// blocks carries dK and dV for every k block and scatters into them; here the
// two sums live in different kernels, each owning its output tile.  GQA is an
// index (`kv_head = head / (Hq / Hkv)`), never a repeat.  Q, K, V, O and dO
// come with their strides; dQ, dK and dV are written contiguous.
//
// The C interface at the end returns the first cudaGetLastError() of the
// three launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "../../csrc/hopper_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// The variants, by the codes of kernel.VARIANT_CODES_BWD (a test holds the
// two to each other): the wrapper's variant_bwd() chooses one and passes its
// code.
enum FaBwdVariant {
  kVarSimt = 0,  // fa_bwd_simt
  kVarMma = 1,   // fa_bwd_bf16_mma
};
enum FaBwdKernel { kDelta, kDkdvSimt, kDqSimt, kDkdvMma, kDqMma, kNumKernels };
const char* const kKernelNames[kNumKernels] = {"fa_bwd_delta", "fa_bwd_dkdv_simt",
                                               "fa_bwd_dq_simt", "fa_bwd_dkdv_mma",
                                               "fa_bwd_dq_mma"};
// The launches of each kernel since the library was loaded, counted at the
// launch once it succeeded (read through fa_bwd_kernel_launches).
long long g_launches[kNumKernels] = {};

cudaError_t counted(cudaError_t e, FaBwdKernel kernel) {
  if (e == cudaSuccess) ++g_launches[kernel];
  return e;
}

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, Hq, Sq] contiguous, natural-log units
  float* delta;      // [B, Hq, Sq] contiguous scratch
  void* dq;          // [B, Hq, Sq, D] contiguous
  void* dk;          // [B, Hkv, Skv, D] contiguous
  void* dv;
  int hq, hkv, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim has stride 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  int causal;
  int window;        // <= 0: no window
  float scale;       // 1 / sqrt(D)
  float scale_log2;  // log2(e) / sqrt(D)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(const BwdParams& p, int qpos, int kpos) {
  bool ok = qpos < p.sq && kpos < p.skv;
  if (p.causal) ok = ok && (qpos >= kpos);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
}

// True when every (q, k) pair of the tile is visible, so masking can be skipped.
__device__ __forceinline__ bool tile_is_full(const BwdParams& p, int q0, int bm,
                                             int k0, int bn) {
  if (q0 + bm > p.sq || k0 + bn > p.skv) return false;
  if (p.causal && k0 + bn - 1 > q0) return false;
  if (p.window > 0 && q0 + bm - 1 - k0 >= p.window) return false;
  return true;
}

// k tiles [lo, hi) of bn rows that hold a key visible to q rows [q0, q0 + bm):
// the forward's bounds.
__device__ __forceinline__ void k_tile_range(const BwdParams& p, int q0, int bm,
                                             int bn, int* lo, int* hi) {
  int h = (p.skv + bn - 1) / bn;
  if (p.causal) h = min(h, (min(q0 + bm, p.sq) - 1) / bn + 1);
  int l = 0;
  if (p.window > 0) l = max(0, (q0 - p.window + 1) / bn);
  *lo = l;
  *hi = h;
}

// q tiles [lo, hi) of bm rows that hold a query that sees a key of rows
// [k0, k0 + bn): causal starts at the key's own tile, a window ends where
// the queries stop seeing the tile's last key.
__device__ __forceinline__ void q_tile_range(const BwdParams& p, int k0, int bn,
                                             int bm, int* lo, int* hi) {
  int last = p.sq - 1;
  if (p.window > 0) last = min(last, k0 + bn - 2 + p.window);
  *lo = p.causal ? k0 / bm : 0;
  *hi = last / bm + 1;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in fp32: one warp a row, 8 rows a block.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256) fa_bwd_delta(BwdParams p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= p.sq) return;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
  const T* d =
      static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + row * p.do_ss;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.hq + h) * p.sq + row] = s;
}

// ---------------------------------------------------------------------------
// fp32: full-precision products on the fp32 pipes.  256 threads as 16 x 16;
// thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 16*j of each
// 64 x 64 tile of logits, and the same rows and columns tx + 16*j of its
// output rows.  Rows of shared memory are D + 1 floats apart (odd: column
// reads hit distinct banks).
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // rows of every tile of the fp32 kernels

template <int D>
constexpr size_t simt_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * (kTile + 4) + 2 * kTile);
}

// Rows [row0, row0 + 64) of a [seq, D] matrix into shared memory with row
// stride D + 1; rows at or beyond `seq` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ss, int row0, int seq) {
  for (int i = threadIdx.x; i < kTile * D; i += 256) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < seq ? src[(row0 + r) * ss + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(256) fa_bwd_dkdv_simt(BwdParams p) {
  constexpr int LD = D + 1;
  constexpr int LDP = kTile + 4;
  constexpr int ND = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [64][LD]
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;   // [64][LDP]: P^T, then dS^T
  float* lse2 = Ps + kTile * LDP;  // [64] lse in base 2
  float* dl = lse2 + kTile;        // [64] delta

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int k_start = blockIdx.x * kTile;

  load_rows_f32<D>(Ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh,
                   p.k_ss, k_start, p.skv);
  load_rows_f32<D>(Vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh,
                   p.v_ss, k_start, p.skv);

  float dk[4][ND], dv[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dk[i][j] = dv[i][j] = 0.f;

  int lo, hi;
  q_tile_range(p, k_start, kTile, kTile, &lo, &hi);
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.sq;
    for (int qt = lo; qt < hi; ++qt) {
      const int q_start = qt * kTile;
      __syncthreads();  // the previous tile's Q, dO, lse and delta are read
      load_rows_f32<D>(Qs, qg, p.q_ss, q_start, p.sq);
      load_rows_f32<D>(dOs, dog, p.do_ss, q_start, p.sq);
      if (tid < kTile) {
        const bool in = q_start + tid < p.sq;
        lse2[tid] = in ? p.lse[row_base + q_start + tid] * kLog2e : 0.f;
        dl[tid] = in ? p.delta[row_base + q_start + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: rows are keys, columns queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * LD + d];
          vv[i] = Vs[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * LD + d];
          ov[j] = dOs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
      const bool full = tile_is_full(p, q_start, kTile, k_start, kTile);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k_start + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const bool vis = full || visible(p, q_start + qc, kpos);
          const float pt = vis ? exp2f(fmaf(st[i][j], p.scale_log2, -lse2[qc])) : 0.f;
          dpt[i][j] = pt * (dpt[i][j] - dl[qc]) * p.scale;
          Ps[(ty * 4 + i) * LDP + qc] = pt;
        }
      }
      // rows ty*4 .. ty*4+3 of Ps are written and read by the same half warp
      __syncwarp();
#pragma unroll 4
      for (int n = 0; n < kTile; ++n) {  // dV += P^T dO
        float pv[4], ov[ND];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + n];
#pragma unroll
        for (int j = 0; j < ND; ++j) ov[j] = dOs[n * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * LDP + tx + 16 * j] = dpt[i][j];
      __syncwarp();
#pragma unroll 4
      for (int n = 0; n < kTile; ++n) {  // dK += dS^T Q
        float sv[4], qv[ND];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ps[(ty * 4 + i) * LDP + n];
#pragma unroll
        for (int j = 0; j < ND; ++j) qv[j] = Qs[n * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
      }
      __syncwarp();
    }
  }

  const long long out_base = (static_cast<long long>(b) * p.hkv + hk) * p.skv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k_start + ty * 4 + i;
    if (kpos >= p.skv) continue;
    float* dkr = static_cast<float*>(p.dk) + (out_base + kpos) * D;
    float* dvr = static_cast<float*>(p.dv) + (out_base + kpos) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      dkr[tx + 16 * j] = dk[i][j];
      dvr[tx + 16 * j] = dv[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256) fa_bwd_dq_simt(BwdParams p) {
  constexpr int LD = D + 1;
  constexpr int LDP = kTile + 4;
  constexpr int ND = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [64][LD]
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // [64][LDP]: dS

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_start = q_tile * kTile;

  load_rows_f32<D>(Qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q_start, p.sq);
  load_rows_f32<D>(dOs,
                   static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
                   p.do_ss, q_start, p.sq);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.sq;
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty * 4 + i;
    lse2[i] = qpos < p.sq ? p.lse[row_base + qpos] * kLog2e : 0.f;
    dl[i] = qpos < p.sq ? p.delta[row_base + qpos] : 0.f;
  }

  float dq[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) dq[i][j] = 0.f;

  int lo, hi;
  k_tile_range(p, q_start, kTile, kTile, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k_start = kt * kTile;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_rows_f32<D>(Ks, kg, p.k_ss, k_start, p.skv);
    load_rows_f32<D>(Vs, vg, p.v_ss, k_start, p.skv);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * LD + d];
        ov[i] = dOs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
    const bool full = tile_is_full(p, q_start, kTile, k_start, kTile);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool vis = full || visible(p, qpos, k_start + tx + 16 * j);
        const float pv = vis ? exp2f(fmaf(s[i][j], p.scale_log2, -lse2[i])) : 0.f;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = pv * (dp[i][j] - dl[i]) * p.scale;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {  // dQ += dS K
      float sv[4], kv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ps[(ty * 4 + i) * LDP + n];
#pragma unroll
      for (int j = 0; j < ND; ++j) kv[j] = Ks[n * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty * 4 + i;
    if (qpos >= p.sq) continue;
    float* dqr = static_cast<float*>(p.dq) + (row_base + qpos) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) dqr[tx + 16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16: every product on mma.sync m16n8k16 with fp32 accumulation.  128
// threads = 4 warps; warp w owns rows w*16 .. w*16+15 of the block's 64
// (queries in fa_bwd_dq_mma, keys in fa_bwd_dkdv_mma).  In the fragment
// layouts g = lane / 4, t = lane % 4: C fragment c0, c1 = (row g, columns
// 8n + 2t, +1), c2, c3 = row g + 8.  Rows of shared memory are D + 8
// elements apart (the 8 rows of one ldmatrix phase fall into distinct banks,
// rows stay 16-byte aligned).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// A fragments of rows [16 w, 16 w + 16) x columns [16 kk, 16 kk + 16) of a
// row-major tile: lane i gives the row address of row i % 16, column 8 (i / 16).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int warp, int kk, int lane) {
  ldmatrix_x4(a, tile + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8);
}

// B fragments of X^T for the n-tiles 2 np and 2 np + 1 at k-step kk, where X
// is a row-major [n][k] tile (the columns of the product are X's rows).
template <int LD>
__device__ __forceinline__ void load_bt(uint32_t (&r)[4], const bf16* tile,
                                        int np, int kk, int lane) {
  ldmatrix_x4(r, tile + ((2 * np + lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                     ((lane / 8) % 2) * 8);
}

// B fragments of X for the n-tiles 2 nd and 2 nd + 1 at k-step kk, where X is
// a row-major [k][n] tile: transposed out of shared memory.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile,
                                       int nd, int kk, int lane) {
  ldmatrix_x4_trans(r, tile + (kk * 16 + lane % 16) * LD + nd * 16 + (lane / 16) * 8);
}

// acc[16 x D] += A[16 x 16 KS] X[16 KS x D], A given as C fragments c[2 KS][4]
// of fp32 (rounded to bf16 here), X row-major in shared memory.
template <int KS, int D, int LD>
__device__ __forceinline__ void mma_cx(float (&acc)[D / 8][4],
                                       const float (&c)[2 * KS][4],
                                       const bf16* X, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t r[4];
      load_b<LD>(r, X, nd, kk, lane);
      mma_bf16_16816(acc[2 * nd], a, r[0], r[1]);
      mma_bf16_16816(acc[2 * nd + 1], a, r[2], r[3]);
    }
  }
}

// s = A1 B1^T and t = A2 B2^T for the warp's 16 rows of A1, A2 ([rows][D] in
// shared memory) against the N rows of B1, B2 ([N][D]).
template <int N, int D, int LD>
__device__ __forceinline__ void mma_two_nt(float (&s)[N / 8][4], float (&t)[N / 8][4],
                                           const bf16* A1, const bf16* B1,
                                           const bf16* A2, const bf16* B2,
                                           int warp, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = t[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a1[4], a2[4];
    load_a<LD>(a1, A1, warp, kk, lane);
    load_a<LD>(a2, A2, warp, kk, lane);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t r[4];
      load_bt<LD>(r, B1, np, kk, lane);
      mma_bf16_16816(s[2 * np], a1, r[0], r[1]);
      mma_bf16_16816(s[2 * np + 1], a1, r[2], r[3]);
      load_bt<LD>(r, B2, np, kk, lane);
      mma_bf16_16816(t[2 * np], a2, r[0], r[1]);
      mma_bf16_16816(t[2 * np + 1], a2, r[2], r[3]);
    }
  }
}

// q rows a step of fa_bwd_dkdv_mma: fewer at head dim 128, where dK and dV
// already hold 128 fp32 registers a thread
template <int D>
__host__ __device__ constexpr int dkdv_q_rows() {
  return D > 80 ? 32 : 64;
}

template <int D>
constexpr size_t mma_dkdv_smem_bytes() {
  return sizeof(bf16) * (2 * kTile + 4 * dkdv_q_rows<D>()) * (D + 8) +
         sizeof(float) * 4 * dkdv_q_rows<D>();
}

template <int D>
constexpr size_t mma_dq_smem_bytes() {
  return sizeof(bf16) * (2 * kTile + 4 * kTile) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(128) fa_bwd_dkdv_mma(BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int BM = dkdv_q_rows<D>();
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + kTile * LD;                     // [64][LD]
  bf16* Qs = Vs + kTile * LD;                     // [2][BM][LD]
  bf16* dOs = Qs + 2 * BM * LD;                   // [2][BM][LD]
  float* lse2 = reinterpret_cast<float*>(dOs + 2 * BM * LD);  // [2][BM]
  float* dl = lse2 + 2 * BM;                                  // [2][BM]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = p.hq / p.hkv;
  const int k_start = blockIdx.x * kTile;

  int lo, hi;
  q_tile_range(p, k_start, kTile, BM, &lo, &hi);
  const int n_q = max(hi - lo, 0);
  const int n_steps = n_q * group;  // (head of the group, q tile), head slowest

  // step i: Q, dO, lse and delta of its head and q tile into buffer `buf`
  auto load_step = [&](int i, int buf) {
    const int h = hk * group + i / n_q;
    const int q_start = (lo + i % n_q) * BM;
    load_tile_async<BM, D, LD>(Qs + buf * BM * LD,
                               static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                               p.q_ss, q_start, p.sq, tid);
    load_tile_async<BM, D, LD>(dOs + buf * BM * LD,
                               static_cast<const bf16*>(p.dout) + b * p.do_sb +
                                   h * p.do_sh,
                               p.do_ss, q_start, p.sq, tid);
    if (tid < BM) {
      const long long row = (static_cast<long long>(b) * p.hq + h) * p.sq + q_start + tid;
      const bool in = q_start + tid < p.sq;
      lse2[buf * BM + tid] = in ? p.lse[row] * kLog2e : 0.f;
      dl[buf * BM + tid] = in ? p.delta[row] : 0.f;
    }
  };

  load_tile_async<kTile, D, LD>(Ks, static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh,
                                p.k_ss, k_start, p.skv, tid);
  load_tile_async<kTile, D, LD>(Vs, static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh,
                                p.v_ss, k_start, p.skv, tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < n_steps; ++i) {
    const int buf = i & 1;
    const int q_start = (lo + i % n_q) * BM;
    // Step i's tiles have arrived, and no warp still reads step i - 1's
    // buffer: the copy of step i + 1 goes there while this step computes.
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_steps) {
      load_step(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* Qb = Qs + buf * BM * LD;
    const bf16* dOb = dOs + buf * BM * LD;
    const float* lse2b = lse2 + buf * BM;
    const float* dlb = dl + buf * BM;

    // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys
    float st[BM / 8][4], dpt[BM / 8][4];
    mma_two_nt<BM, D, LD>(st, dpt, Ks, Qb, Vs, dOb, warp, lane);
    const bool full = tile_is_full(p, q_start, BM, k_start, kTile);
    const int krow = k_start + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t + (e & 1);
        const bool vis = full || visible(p, q_start + qc, krow + (e >> 1) * 8);
        const float pt =
            vis ? fast_exp2(fmaf(st[n][e], p.scale_log2, -lse2b[qc])) : 0.f;
        st[n][e] = pt;
        dpt[n][e] = pt * (dpt[n][e] - dlb[qc]) * p.scale;
      }
    }
    mma_cx<BM / 16, D, LD>(dv, st, dOb, lane);   // dV += P^T dO
    mma_cx<BM / 16, D, LD>(dk, dpt, Qb, lane);   // dK += dS^T Q
  }
  cp_async_wait<0>();

  const long long out_base = (static_cast<long long>(b) * p.hkv + hk) * p.skv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k_start + warp * 16 + g + r * 8;
    if (kpos >= p.skv) continue;
    bf16* dkr = static_cast<bf16*>(p.dk) + (out_base + kpos) * D + 2 * t;
    bf16* dvr = static_cast<bf16*>(p.dv) + (out_base + kpos) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + n * 8) = pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvr + n * 8) = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) fa_bwd_dq_mma(BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dOs = Qs + kTile * LD;                    // [64][LD]
  bf16* Ks = dOs + kTile * LD;                    // [2][64][LD]
  bf16* Vs = Ks + 2 * kTile * LD;                 // [2][64][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_start = q_tile * kTile;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  int lo, hi;
  k_tile_range(p, q_start, kTile, kTile, &lo, &hi);
  load_tile_async<kTile, D, LD>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
                                p.q_ss, q_start, p.sq, tid);
  load_tile_async<kTile, D, LD>(dOs,
                                static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                                p.do_ss, q_start, p.sq, tid);
  if (lo < hi) {
    load_tile_async<kTile, D, LD>(Ks, kg, p.k_ss, lo * kTile, p.skv, tid);
    load_tile_async<kTile, D, LD>(Vs, vg, p.v_ss, lo * kTile, p.skv, tid);
  }
  cp_async_commit();

  // rows g and g + 8 of the warp's 16
  const long long row_base = (static_cast<long long>(b) * p.hq + h) * p.sq;
  const int row0 = q_start + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    lse2[r] = qpos < p.sq ? p.lse[row_base + qpos] * kLog2e : 0.f;
    dl[r] = qpos < p.sq ? p.delta[row_base + qpos] : 0.f;
  }
  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1;
    const int k_start = kt * kTile;
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < hi) {
      load_tile_async<kTile, D, LD>(Ks + (buf ^ 1) * kTile * LD, kg, p.k_ss,
                                    (kt + 1) * kTile, p.skv, tid);
      load_tile_async<kTile, D, LD>(Vs + (buf ^ 1) * kTile * LD, vg, p.v_ss,
                                    (kt + 1) * kTile, p.skv, tid);
      cp_async_commit();
    }
    const bf16* Kb = Ks + buf * kTile * LD;
    const bf16* Vb = Vs + buf * kTile * LD;

    // S = Q K^T and dP = dO V^T
    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_two_nt<kTile, D, LD>(s, dp, Qs, Kb, dOs, Vb, warp, lane);
    const bool full = tile_is_full(p, q_start, kTile, k_start, kTile);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool vis =
            full || visible(p, row0 + r * 8, k_start + n * 8 + 2 * t + (e & 1));
        const float pv = vis ? fast_exp2(fmaf(s[n][e], p.scale_log2, -lse2[r])) : 0.f;
        s[n][e] = pv * (dp[n][e] - dl[r]) * p.scale;
      }
    }
    mma_cx<kTile / 16, D, LD>(dq, s, Kb, lane);  // dQ += dS K
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= p.sq) continue;
    bf16* dqr = static_cast<bf16*>(p.dq) + (row_base + qpos) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dqr + n * 8) = pack_bf16(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// More than 48 KB of dynamic shared memory has to be asked for: once for each
// kernel, so the static is one per instance of this template.
template <void (*Kernel)(BwdParams), FaBwdKernel kWhich, int kThreads, size_t kSmem>
cudaError_t launch(const BwdParams& p, dim3 grid, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  Kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return counted(cudaGetLastError(), kWhich);
}

template <int D>
cudaError_t launch_d(const BwdParams& p, int batch, int variant, cudaStream_t s) {
  const dim3 rows((p.sq + 7) / 8, p.hq, batch);
  const dim3 k_tiles((p.skv + kTile - 1) / kTile, p.hkv, batch);
  const dim3 q_tiles((p.sq + kTile - 1) / kTile, p.hq, batch);
  cudaError_t e;
  if (variant == kVarMma) {
    e = launch<fa_bwd_delta<bf16, D>, kDelta, 256, 0>(p, rows, s);
    if (e != cudaSuccess) return e;
    e = launch<fa_bwd_dkdv_mma<D>, kDkdvMma, 128, mma_dkdv_smem_bytes<D>()>(p, k_tiles, s);
    if (e != cudaSuccess) return e;
    return launch<fa_bwd_dq_mma<D>, kDqMma, 128, mma_dq_smem_bytes<D>()>(p, q_tiles, s);
  }
  e = launch<fa_bwd_delta<float, D>, kDelta, 256, 0>(p, rows, s);
  if (e != cudaSuccess) return e;
  e = launch<fa_bwd_dkdv_simt<D>, kDkdvSimt, 256, simt_smem_bytes<D>()>(p, k_tiles, s);
  if (e != cudaSuccess) return e;
  return launch<fa_bwd_dq_simt<D>, kDqSimt, 256, simt_smem_bytes<D>()>(p, q_tiles, s);
}

}  // namespace

// variant: 0 = fa_bwd_simt (float32 tensors), 1 = fa_bwd_bf16_mma (bfloat16
// tensors), chosen by the wrapper.  q, k, v, o and dout come with their
// strides in elements (the last dimension of each has stride 1; for bfloat16
// every row starts on a 16-byte boundary); lse [B, Hq, Sq] fp32 contiguous is
// the forward's; delta is [B, Hq, Sq] fp32 scratch; dq [B, Hq, Sq, D] and dk,
// dv [B, Hkv, Skv, D] are written contiguous, in the inputs' type.  Launches
// fa_bwd_delta, then the dK/dV kernel, then the dQ kernel on `stream`.
// Returns the first failing launch's cudaError_t as an int (0 = success;
// cudaErrorInvalidValue for a head dim or variant that has no kernel).
extern "C" int fa_bwd(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* delta, void* dq,
                      void* dk, void* dv, int batch, int hq, int hkv, int sq,
                      int skv, int d, long long q_sb, long long q_sh,
                      long long q_ss, long long k_sb, long long k_sh,
                      long long k_ss, long long v_sb, long long v_sh,
                      long long v_ss, long long o_sb, long long o_sh,
                      long long o_ss, long long do_sb, long long do_sh,
                      long long do_ss, int causal, int window, float scale,
                      int variant, void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.causal = causal; p.window = window;
  p.scale = scale; p.scale_log2 = scale * kLog2e;
  if (variant != kVarSimt && variant != kVarMma)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return static_cast<int>(launch_d<32>(p, batch, variant, s));
    case 64: return static_cast<int>(launch_d<64>(p, batch, variant, s));
    case 80: return static_cast<int>(launch_d<80>(p, batch, variant, s));
    case 128: return static_cast<int>(launch_d<128>(p, batch, variant, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The library's CUDA kernels by index (null past the last), and the launches
// of each since the library was loaded.
extern "C" const char* fa_bwd_kernel_name(int i) {
  return (i >= 0 && i < kNumKernels) ? kKernelNames[i] : nullptr;
}
extern "C" long long fa_bwd_kernel_launches(int i) {
  return (i >= 0 && i < kNumKernels) ? g_launches[i] : -1;
}

extern "C" const char* fa_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
