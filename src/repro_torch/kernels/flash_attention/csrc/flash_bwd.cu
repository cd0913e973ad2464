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
// Three variants (the wrapper's `kernel.variant_bwd()` chooses from dtype and
// head dim, and passes its code in):
//  * `fa_bwd_wgmma`, bf16 at head dims 64 and 128 (tinyllama-1.1b's
//    training path): two CUDA kernels on wgmma + TMA, described at the
//    section below that holds them.  dQ first, whose items also compute delta,
//    then dK/dV.
//  * `fa_bwd_bf16_mma`, bf16 at head dims 32 and 80, and `fa_bwd_simt`,
//    fp32: three CUDA kernels each.
//    - `fa_bwd_delta`: delta, one warp a row, fp32.
//    - `fa_bwd_dkdv_*`: one block per (batch, KV head, 64-row k tile).  It
//      loops over the q tiles of every query head of the group, so dK and dV
//      are summed in registers, without atomics; the loop bounds are the
//      forward's seen from the key's side (causal: from the diagonal tile
//      on; window: up to the last query that still sees the tile).
//    - `fa_bwd_dq_*`: one block per (batch, query head, 64-row q tile),
//      looping over the k tiles in the forward's bounds.
//    `*_simt` computes in full fp32 on the fp32 pipes, thread micro-tiles
//    of 4 x 4 as in the forward's fp32 kernel.  `*_mma` runs every product
//    on `mma.sync.m16n8k16` with fp32 accumulation, operands through
//    `ldmatrix` from shared memory, the next tile's copy by `cp.async` while
//    this one is computed on.
// In the bf16 variants P and dS are rounded to bf16 as the A operands of the
// second products.  No variant uses atomics (a result is the same from
// run to run), and S and dP are computed twice, once in each of the kernels
// that own dQ and dK/dV: seven products for the five.
//
// What the design changes against the JAX function.  There one scan over q
// blocks carries dK and dV for every k block and scatters into them; here the
// two sums live in different kernels, each owning its output tile.  GQA is an
// index (`kv_head = head / (Hq / Hkv)`), never a repeat.  Q, K, V, O and dO
// come with their strides; dQ, dK and dV are written contiguous.
//
// The C interface at the end returns the first failing cudaGetLastError() of
// its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "../../csrc/hopper_mma.cuh"
#include "../../csrc/hopper_sm90.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// The variants, by the codes of kernel.VARIANT_CODES_BWD (a test holds the
// two to each other): the wrapper's variant_bwd() chooses one and passes its
// code.
enum FaBwdVariant {
  kVarSimt = 0,   // fa_bwd_simt
  kVarMma = 1,    // fa_bwd_bf16_mma
  kVarWgmma = 2,  // fa_bwd_wgmma
};
enum FaBwdKernel {
  kDelta, kDkdvSimt, kDqSimt, kDkdvMma, kDqMma, kDqWgmma, kDkdvWgmma, kNumKernels
};
const char* const kKernelNames[kNumKernels] = {
    "fa_bwd_delta",  "fa_bwd_dkdv_simt", "fa_bwd_dq_simt",   "fa_bwd_dkdv_mma",
    "fa_bwd_dq_mma", "fa_bwd_dq_wgmma",  "fa_bwd_dkdv_wgmma"};
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

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: wgmma and TMA (hopper_sm90.cuh), two CUDA
// kernels a call and no atomics.  Both are persistent (one block per SM
// walking a list of items, longest first under the causal mask, handed out
// in a snake: wave w of the list left to right when w is even, right to left
// when odd, so the blocks that drew the longest items of a wave draw the
// shortest of the next), with a producer that keeps a TMA ring of 64-row
// tiles full (128-byte swizzle, one mbarrier a stage for the copies, one for
// the consumers' release) and two consumer warpgroups that each own 64 rows
// of the item and run free of each other.  Every product is wgmma: the first
// two of a step (S and dP, or their transposes) with both operands in shared
// memory, K-major; the probabilities and dS are rounded to bf16 in registers
// and repacked from the accumulator into A fragments (hopper_sm90.cuh's
// layout note) for the second products, whose B operand is MN-major.  P is a
// select on the mask, never a multiply, so a row that sees no key has P = 0
// whatever its lse.
//
//  * fa_bwd_dq_wgmma, first: one item per (128-row q tile, batch, query
//    head), 288 threads (two consumer warpgroups and a producer warp).  The
//    producer brings the item's Q and dO (two buffers, so it runs on into the
//    next item) and the K and V tiles of the forward's bounds.  Each
//    warpgroup first computes delta = rowsum(dO * O) of its 64 rows from dO
//    in shared memory and O from device memory, and writes it, with lse in
//    base 2, to the row-statistics scratch that the second kernel reads;
//    then per K/V tile S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K.
//  * fa_bwd_dkdv_wgmma, second: one item per (128-row k tile, batch, KV
//    head), 384 threads: a whole producer warpgroup gives its registers to
//    the two consumer warpgroups (setmaxnreg: 24 and 240 a thread), which
//    hold dK and dV (at head dim 128, 128 fp32 registers) besides S^T and
//    dP^T.  K and V of the item stay in shared memory; the producer streams
//    (query head of the group, 64-row q tile) steps in the reverse bounds:
//    Q, dO and the 64 rows of lse and delta (one bulk copy).  Per step
//    S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q, so
//    the group's sum stays in registers.
// S and dP are computed in both kernels: seven products for five, the price
// of no atomics and of results equal from run to run.
//
// What holds them (PERF.md): neither the tensor cores nor the ex2 unit, but
// the latency of each warpgroup's chain per tile (wait for the tiles, first
// products, elementwise pass, second products), which the two warpgroups
// only partly hide from each other.  So the elementwise pass tests the mask
// only in tiles that hold a pair it hides (a uniform branch between two
// copies of the pass; testing every element took 22 instructions an element
// and a third of the time), and at head dim 64 a tile's second products
// stay in flight while the next tile's first ones are issued
// (chain_products).
// ---------------------------------------------------------------------------

constexpr int kWRows = 128;  // rows of an item: q rows (dQ) or k rows (dK/dV)
constexpr int kWTile = 64;   // rows of a streamed tile: K/V (dQ), Q/dO (dK/dV)

template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D == 64 ? 6 : 3;  // what fits beside two Q and two dO buffers
}
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D == 64 ? 6 : 4;  // what fits beside K and V of the item
}

template <int D>
constexpr size_t dq_wgmma_smem_bytes() {
  // alignment slack; Q and dO, two buffers each of [128][D]; K and V,
  // dq_stages() stages of [64][D] each; delta of each warpgroup's rows, two
  // buffers; barriers
  return 1024 + sizeof(bf16) * (4 * kWRows * D + 2 * dq_stages<D>() * kWTile * D) +
         sizeof(float) * 2 * 2 * 64 + 8 * (4 + 2 * dq_stages<D>());
}
template <int D>
constexpr size_t dkdv_wgmma_smem_bytes() {
  // alignment slack; K and V of the item, [128][D] each; Q and dO,
  // dkdv_stages() stages of [64][D] each, with 64 rows of lse and delta;
  // barriers
  return 1024 + sizeof(bf16) * (2 * kWRows * D + 2 * dkdv_stages<D>() * kWTile * D) +
         sizeof(float) * 128 * dkdv_stages<D>() + 8 * (2 + 2 * dkdv_stages<D>());
}

// Whether a tile's second products stay in flight while the next tile's
// first ones are issued (one wgmma wait a tile instead of two).  At head dim
// 128 ptxas serializes every wgmma of a kernel written so (its accumulators
// take twice the registers), which costs more than the wait saves
// (scripts/flash_bwd_ablation.py, variants `chained` and `unchained`;
// PERF.md).
template <int D>
__host__ __device__ constexpr bool chain_products() {
  return D == 64;
}

struct BwdTma {
  int n_items, n_tiles, batch;
  int stat_blocks;  // 64-row blocks of the row statistics of one (b, head)
  // 1 when dimension 1 of the tensor's map is the sequence (map_bhsd)
  int q_s_first, k_s_first, v_s_first, do_s_first;
};

// The item that a block takes on its n-th turn: the list in waves of
// gridDim.x, every other wave walked backwards.
__device__ __forceinline__ int snake_item(int n) {
  return n * gridDim.x +
         ((n & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x);
}

// False when no (q, k) pair of the tile is visible: the warpgroup skips it.
__device__ __forceinline__ bool sees_any(const BwdParams& p, int q0, int bm,
                                         int k0, int bn) {
  if (q0 >= p.sq || k0 >= p.skv) return false;
  if (p.causal && q0 + bm - 1 < k0) return false;
  if (p.window > 0 && q0 - (k0 + bn - 1) >= p.window) return false;
  return true;
}

__device__ __forceinline__ float dot8_bf16(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s = fmaf(fx.x, fy.x, s);
    s = fmaf(fx.y, fy.y, s);
  }
  return s;
}

// rows [pos, pos + ROWS) of one head of a [B, H, S, D] tensor, every
// 64-column atom, into dst ([D / 64][ROWS][64], swizzled)
template <int D, int ROWS>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map,
                                         int s_first, uint64_t* bar, int pos,
                                         int head, int b) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a)
    tma_load_4d(dst + a * ROWS * 64, map, bar, a * 64, s_first ? pos : head,
                s_first ? head : pos, b);
}

// K-major operand, k-step kk, of a [D / 64][ROWS][64] swizzled tile
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int kk) {
  return sw128_desc(tile + (kk / 4) * ROWS * 64 + (kk % 4) * 16, 16, 1024);
}
// MN-major operand (rows are the reduction index), k-step kk, of a
// [D / 64][ROWS][64] swizzled tile
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int kk) {
  return sw128_desc(tile + kk * 16 * 64, ROWS * 128, 1024);
}

// acc[64 x D] += A[64 x 16] B, B an MN-major operand of D columns
template <int D>
__device__ __forceinline__ void wgmma_rs_d(float (&acc)[D / 2],
                                           const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64<1>(acc, a, db, 1);
  } else {
    wgmma_rs_n128<1>(acc, a, db, 1);
  }
}

// dS of one 64 x 64 tile of the dQ kernel, from the accumulators of S
// (sc) and dP (dp), as the bf16 A fragments of the four k-steps of
// dQ += dS K.  sc[i] is row row0 + 8 ((i / 2) % 2), key kcol0 + 8 (i / 4) +
// i % 2.  P is a select on the mask, so a row whose lse is the masked logit
// (no key seen) gets P = 0; kMask: the tile holds a pair that is not
// visible (the uniform branch around this call keeps the mask's arithmetic
// out of the tiles that need none).
template <bool kMask>
__device__ __forceinline__ void dq_fragments(uint32_t (&da)[4][4],
                                             const float (&sc)[32],
                                             const float (&dp)[32],
                                             const BwdParams& p,
                                             const float (&lse2)[2],
                                             const float (&dls)[2], int row0,
                                             int kcol0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float ds[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e, r = (e >> 1) & 1;
      float pv = fast_exp2(fmaf(sc[i], p.scale_log2, -lse2[r]));
      if (kMask && !visible(p, row0 + 8 * r, kcol0 + 8 * (i / 4) + (i & 1))) pv = 0.f;
      ds[e] = pv * fmaf(dp[i], p.scale, -dls[r]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) da[kk][f] = pack_bf16(ds[2 * f], ds[2 * f + 1]);
  }
}

// P^T and dS^T of one 64 x 64 tile of the dK/dV kernel, from the
// accumulators of S^T (st) and dP^T (dpt), as the bf16 A fragments of the
// four k-steps of dV += P^T dO and dK += dS^T Q.  st[i] is key krow0 +
// 8 ((i / 2) % 2), query qcol0 + 8 (i / 4) + i % 2; lse2 and dl hold the
// tile's 64 queries (lse in base 2, delta); the mask as in dq_fragments.
template <bool kMask>
__device__ __forceinline__ void dkdv_fragments(uint32_t (&pa)[4][4],
                                               uint32_t (&sa)[4][4],
                                               const float (&st)[32],
                                               const float (&dpt)[32],
                                               const BwdParams& p,
                                               const float* lse2, const float* dl,
                                               int qcol0, int krow0) {
  const int c0 = qcol0 & 63;  // this thread's first query column of the tile
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float pv[8], ds[8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = 8 * (2 * kk + hf);
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c0 + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + c0 + c);
      const float ds0 = d2.x * p.scale, ds1 = d2.y * p.scale;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 4 * hf + e;
        float pt = fast_exp2(fmaf(st[i], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
        if (kMask && !visible(p, qcol0 + c + (e & 1), krow0 + 8 * (e >> 1))) pt = 0.f;
        pv[4 * hf + e] = pt;
        ds[4 * hf + e] = pt * fmaf(dpt[i], p.scale, -((e & 1) ? ds1 : ds0));
      }
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      pa[kk][f] = pack_bf16(pv[2 * f], pv[2 * f + 1]);
      sa[kk][f] = pack_bf16(ds[2 * f], ds[2 * f + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(288, 1)
    fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, BwdParams p,
                    BwdTma t) {
  constexpr int KD = D / 16;       // k-steps of S and dP
  constexpr int KN = kWTile / 16;  // k-steps of dQ += dS K
  constexpr int ST = dq_stages<D>();
  constexpr uint32_t ITEM_TILE = kWRows * D * sizeof(bf16);
  constexpr uint32_t TILE = kWTile * D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2][NA][128][64]
  bf16* dOs = Qs + 2 * kWRows * D;                           // [2][NA][128][64]
  bf16* Ks = dOs + 2 * kWRows * D;                           // [ST][NA][64][64]
  bf16* Vs = Ks + ST * kWTile * D;                           // [ST][NA][64][64]
  float* dls = reinterpret_cast<float*>(Vs + ST * kWTile * D);  // [2 wg][2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dls + 256);
  uint64_t* q_full = bars;           // [2]: Q and dO of an item
  uint64_t* q_empty = bars + 2;      // [2], one arrival per consumer thread
  uint64_t* full = bars + 4;         // [ST]: K and V of a tile
  uint64_t* empty = bars + 4 + ST;   // [ST], one arrival per consumer thread

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 256);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int bh = p.hq * t.batch;
  const int group = p.hq / p.hkv;
  const int warp_id = warp_index();
  if (warp_id == 8) {
    // the producer warp; one lane issues every copy, item after item
    if (tid != 256) return;
    int ring = 0;  // K/V tiles this block has loaded
    for (int n = 0;; ++n) {
      const int j = snake_item(n);
      if (j >= t.n_items) break;
      const int q_start = (t.n_tiles - 1 - j / bh) * kWRows;
      const int h = j % p.hq, b = (j % bh) / p.hq;
      int lo, hi;
      k_tile_range(p, q_start, kWRows, kWTile, &lo, &hi);
      const int qb = n & 1;
      if (n >= 2) mbar_wait(q_empty + qb, (n / 2 - 1) & 1);
      mbar_expect_tx(q_full + qb, 2 * ITEM_TILE);
      tma_rows<D, kWRows>(Qs + qb * kWRows * D, &tq, t.q_s_first, q_full + qb,
                          q_start, h, b);
      tma_rows<D, kWRows>(dOs + qb * kWRows * D, &tdo, t.do_s_first, q_full + qb,
                          q_start, h, b);
      for (int kt = lo; kt < hi; ++kt, ++ring) {
        const int s = ring % ST;
        if (ring >= ST) mbar_wait(empty + s, (ring / ST - 1) & 1);
        mbar_expect_tx(full + s, 2 * TILE);
        tma_rows<D, kWTile>(Ks + s * kWTile * D, &tk, t.k_s_first, full + s,
                            kt * kWTile, h / group, b);
        tma_rows<D, kWTile>(Vs + s * kWTile * D, &tv, t.v_s_first, full + s,
                            kt * kWTile, h / group, b);
      }
    }
    return;
  }

  const int wg = warp_id / 4, warp = warp_id % 4, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const int wt = tid - wg * 128;  // thread of the warpgroup
  int ring = 0;
  for (int n = 0;; ++n) {
    const int j = snake_item(n);
    if (j >= t.n_items) break;
    const int q_start = (t.n_tiles - 1 - j / bh) * kWRows;
    const int h = j % p.hq, b = (j % bh) / p.hq;
    int lo, hi;
    k_tile_range(p, q_start, kWRows, kWTile, &lo, &hi);
    const int qb = n & 1;
    const bf16* Qw = Qs + qb * kWRows * D + wg * 64 * 64;  // this warpgroup's rows
    const bf16* dOw = dOs + qb * kWRows * D + wg * 64 * 64;
    const int qw_start = q_start + wg * 64;
    const long long bhrow = static_cast<long long>(b) * p.hq + h;
    // delta of the warpgroup's 64 rows, two threads a row: O from device
    // memory, its loads (and those of lse) issued before the wait for Q and
    // dO, then dO from the swizzled buffer (16-byte chunk c of row R sits at
    // chunk c ^ (R % 8) of its atom)
    const int r_d = wt / 2, half = wt % 2;
    const int qpos_d = qw_start + r_d;
    const int R = wg * 64 + r_d;  // row of the 128-row buffer
    uint4 ov[D / 16];
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      ov[i] = make_uint4(0u, 0u, 0u, 0u);
      if (qpos_d < p.sq)
        ov[i] = *reinterpret_cast<const uint4*>(
            static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh +
            qpos_d * p.o_ss + (half * (D / 16) + i) * 8);
    }
    const float lse2_d = qpos_d < p.sq ? p.lse[bhrow * p.sq + qpos_d] * kLog2e : 0.f;
    // rows g and g + 8 of the warp's 16
    const int row0 = qw_start + warp * 16 + g;
    float lse2[2], dl_s[2];  // lse in base 2; delta times the scale
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + r * 8;
      lse2[r] = qpos < p.sq ? p.lse[bhrow * p.sq + qpos] * kLog2e : 0.f;
    }
    mbar_wait(q_full + qb, (n / 2) & 1);

    float* dlw = dls + (wg * 2 + qb) * 64;
    {
      float acc = 0.f;
      const bf16* drow = dOs + qb * kWRows * D + R * 64;
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int c = half * (D / 16) + i;  // 16-byte chunk of the row
        acc += dot8_bf16(ov[i], *reinterpret_cast<const uint4*>(
                                    drow + (c / 8) * kWRows * 64 + ((c % 8) ^ (R & 7)) * 8));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        dlw[r_d] = acc;
        // the dK/dV kernel's copy, rows past Sq included: lse in base 2,
        // then delta, 64 rows a block
        float* st = p.delta + (bhrow * t.stat_blocks + qpos_d / 64) * 128 + qpos_d % 64;
        st[0] = lse2_d;
        st[64] = acc;
      }
      named_barrier(1 + wg, 128);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) dl_s[r] = dlw[warp * 16 + g + r * 8] * p.scale;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // At head dim 64 the dQ product of a tile runs on while the next tile's S
    // and dP are issued: one wait covers both, and the tile's stage is
    // released after it (chain_products).
    uint32_t da[KN][4] = {};
    int pending = -1;  // the stage whose K the dQ product in flight reads
    for (int kt = lo; kt < hi; ++kt, ++ring) {
      const int s = ring % ST;
      const int k_start = kt * kWTile;
      mbar_wait(full + s, (ring / ST) & 1);
      if (!sees_any(p, qw_start, 64, k_start, kWTile)) {
        // a stage held while stages are skipped could stall the ring
        if (pending >= 0) {
          wgmma_wait<0>();
          fence_regs(dq);
          mbar_arrive(empty + pending);
          pending = -1;
        }
        mbar_arrive(empty + s);
        continue;
      }
      const bf16* Kt = Ks + s * kWTile * D;
      const bf16* Vt = Vs + s * kWTile * D;
      // S = Q K^T and dP = dO V^T; the first k-step only writes
      float sc[32], dp[32];
      wgmma_fence();
      wgmma_ss_n64_first<0, 0>(sc, kmajor<kWRows>(Qw, 0), kmajor<kWTile>(Kt, 0));
#pragma unroll
      for (int kk = 1; kk < KD; ++kk)
        wgmma_ss_n64<0, 0>(sc, kmajor<kWRows>(Qw, kk), kmajor<kWTile>(Kt, kk), 1);
      wgmma_ss_n64_first<0, 0>(dp, kmajor<kWRows>(dOw, 0), kmajor<kWTile>(Vt, 0));
#pragma unroll
      for (int kk = 1; kk < KD; ++kk)
        wgmma_ss_n64<0, 0>(dp, kmajor<kWRows>(dOw, kk), kmajor<kWTile>(Vt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();  // S and dP, and the previous tile's dQ product
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) fence_regs(da[kk]);
      if (pending >= 0) mbar_arrive(empty + pending);

      // sc[i]: row row0 + 8 ((i / 2) % 2), column k_start + 8 (i / 4) +
      // 2 qd + i % 2; dS as the bf16 A fragments of dQ += dS K
      if (tile_is_full(p, qw_start, 64, k_start, kWTile)) {
        dq_fragments<false>(da, sc, dp, p, lse2, dl_s, row0, k_start + 2 * qd);
      } else {
        dq_fragments<true>(da, sc, dp, p, lse2, dl_s, row0, k_start + 2 * qd);
      }
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) fence_regs(da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) wgmma_rs_d<D>(dq, da[kk], mnmajor<kWTile>(Kt, kk));
      wgmma_commit();
      if constexpr (chain_products<D>()) {
        pending = s;
      } else {
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) fence_regs(da[kk]);
        mbar_arrive(empty + s);
      }
    }
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) fence_regs(da[kk]);
    if (pending >= 0) mbar_arrive(empty + pending);  // this thread is done with it
    mbar_arrive(q_empty + qb);  // and with this item's Q and dO

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + r * 8;
      if (qpos >= p.sq) continue;
      bf16* dqr = static_cast<bf16*>(p.dq) + (bhrow * p.sq + qpos) * D + 2 * qd;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
        *reinterpret_cast<uint32_t*>(dqr + nn * 8) =
            pack_bf16(dq[4 * nn + 2 * r], dq[4 * nn + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo, BwdParams p,
                      BwdTma t) {
  constexpr int KD = D / 16;       // k-steps of S^T and dP^T
  constexpr int KN = kWTile / 16;  // k-steps of dV += P^T dO and dK += dS^T Q
  constexpr int ST = dkdv_stages<D>();
  constexpr uint32_t ITEM_TILE = kWRows * D * sizeof(bf16);
  constexpr uint32_t TILE = kWTile * D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));  // [NA][128][64]
  bf16* Vs = Ks + kWRows * D;                                // [NA][128][64]
  bf16* Qs = Vs + kWRows * D;                                // [ST][NA][64][64]
  bf16* dOs = Qs + ST * kWTile * D;                          // [ST][NA][64][64]
  float* stats = reinterpret_cast<float*>(dOs + ST * kWTile * D);  // [ST][2][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(stats + ST * 128);
  uint64_t* kv_full = bars;          // K and V of an item
  uint64_t* kv_empty = bars + 1;     // one arrival per consumer thread
  uint64_t* full = bars + 2;         // [ST]: Q, dO, lse and delta of a step
  uint64_t* empty = bars + 2 + ST;   // [ST], one arrival per consumer thread

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 256);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int bhk = p.hkv * t.batch;
  const int group = p.hq / p.hkv;
  const int warp_id = warp_index();
  if (warp_id >= 8) {
    // the producer warpgroup gives its registers to the consumers; one lane
    // issues every copy, item after item
    setmaxnreg_dec<24>();
    if (tid != 256) return;
    int ring = 0;  // steps this block has loaded
    for (int n = 0;; ++n) {
      const int j = snake_item(n);
      if (j >= t.n_items) break;
      const int k_start = (j / bhk) * kWRows;
      const int hk = j % p.hkv, b = (j % bhk) / p.hkv;
      int lo, hi;
      q_tile_range(p, k_start, kWRows, kWTile, &lo, &hi);
      const int n_q = max(hi - lo, 0);
      if (n >= 1) mbar_wait(kv_empty, (n - 1) & 1);
      mbar_expect_tx(kv_full, 2 * ITEM_TILE);
      tma_rows<D, kWRows>(Ks, &tk, t.k_s_first, kv_full, k_start, hk, b);
      tma_rows<D, kWRows>(Vs, &tv, t.v_s_first, kv_full, k_start, hk, b);
      for (int i = 0; i < n_q * group; ++i, ++ring) {
        const int h = hk * group + i / n_q;
        const int q_start = (lo + i % n_q) * kWTile;
        const int s = ring % ST;
        if (ring >= ST) mbar_wait(empty + s, (ring / ST - 1) & 1);
        mbar_expect_tx(full + s, 2 * TILE + 128 * sizeof(float));
        tma_rows<D, kWTile>(Qs + s * kWTile * D, &tq, t.q_s_first, full + s,
                            q_start, h, b);
        tma_rows<D, kWTile>(dOs + s * kWTile * D, &tdo, t.do_s_first, full + s,
                            q_start, h, b);
        bulk_load(stats + s * 128,
                  p.delta + ((static_cast<long long>(b) * p.hq + h) * t.stat_blocks +
                             q_start / 64) * 128,
                  128 * sizeof(float), full + s);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = warp_id / 4, warp = warp_id % 4, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  int ring = 0;
  for (int n = 0;; ++n) {
    const int j = snake_item(n);
    if (j >= t.n_items) break;
    const int k_start = (j / bhk) * kWRows;
    const int hk = j % p.hkv, b = (j % bhk) / p.hkv;
    int lo, hi;
    q_tile_range(p, k_start, kWRows, kWTile, &lo, &hi);
    const int n_q = max(hi - lo, 0);
    const bf16* Kw = Ks + wg * 64 * 64;  // this warpgroup's keys
    const bf16* Vw = Vs + wg * 64 * 64;
    const int kw_start = k_start + wg * 64;
    const int krow0 = kw_start + warp * 16 + g;  // rows g and g + 8 of the warp's 16
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, n & 1);

    // At head dim 64 dV and dK of a step run on while the next step's S^T and
    // dP^T are issued: one wait covers both, and the step's stage is released
    // after it (chain_products).
    uint32_t pa[KN][4] = {}, sa[KN][4] = {};
    int pending = -1;  // the stage whose Q and dO the products in flight read
    for (int i = 0; i < n_q * group; ++i, ++ring) {
      const int q_start = (lo + i % n_q) * kWTile;
      const int s = ring % ST;
      mbar_wait(full + s, (ring / ST) & 1);
      if (!sees_any(p, q_start, kWTile, kw_start, 64)) {
        // a stage held while stages are skipped could stall the ring
        if (pending >= 0) {
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(dv);
          mbar_arrive(empty + pending);
          pending = -1;
        }
        mbar_arrive(empty + s);
        continue;
      }
      const bf16* Qt = Qs + s * kWTile * D;
      const bf16* dOt = dOs + s * kWTile * D;
      const float* lse2 = stats + s * 128;  // base 2
      const float* dl = lse2 + 64;
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      float st[32], dpt[32];
      wgmma_fence();
      wgmma_ss_n64_first<0, 0>(st, kmajor<kWRows>(Kw, 0), kmajor<kWTile>(Qt, 0));
#pragma unroll
      for (int kk = 1; kk < KD; ++kk)
        wgmma_ss_n64<0, 0>(st, kmajor<kWRows>(Kw, kk), kmajor<kWTile>(Qt, kk), 1);
      wgmma_ss_n64_first<0, 0>(dpt, kmajor<kWRows>(Vw, 0), kmajor<kWTile>(dOt, 0));
#pragma unroll
      for (int kk = 1; kk < KD; ++kk)
        wgmma_ss_n64<0, 0>(dpt, kmajor<kWRows>(Vw, kk), kmajor<kWTile>(dOt, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();  // S^T and dP^T, and the previous step's dV and dK
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(sa[kk]);
      }
      if (pending >= 0) mbar_arrive(empty + pending);

      // st[i]: key krow0 + 8 ((i / 2) % 2), query q_start + 8 (i / 4) +
      // 2 qd + i % 2; P^T and dS^T as the bf16 A fragments of the second
      // products
      if (tile_is_full(p, q_start, kWTile, kw_start, 64)) {
        dkdv_fragments<false>(pa, sa, st, dpt, p, lse2, dl, q_start + 2 * qd, krow0);
      } else {
        dkdv_fragments<true>(pa, sa, st, dpt, p, lse2, dl, q_start + 2 * qd, krow0);
      }
      fence_regs(dk);
      fence_regs(dv);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(sa[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) wgmma_rs_d<D>(dv, pa[kk], mnmajor<kWTile>(dOt, kk));
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) wgmma_rs_d<D>(dk, sa[kk], mnmajor<kWTile>(Qt, kk));
      wgmma_commit();
      if constexpr (chain_products<D>()) {
        pending = s;
      } else {
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(sa[kk]);
        }
        mbar_arrive(empty + s);
      }
    }
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      fence_regs(pa[kk]);
      fence_regs(sa[kk]);
    }
    if (pending >= 0) mbar_arrive(empty + pending);  // this thread is done with it
    mbar_arrive(kv_empty);  // and with this item's K and V

    const long long out_base = (static_cast<long long>(b) * p.hkv + hk) * p.skv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = krow0 + r * 8;
      if (kpos >= p.skv) continue;
      bf16* dkr = static_cast<bf16*>(p.dk) + (out_base + kpos) * D + 2 * qd;
      bf16* dvr = static_cast<bf16*>(p.dv) + (out_base + kpos) * D + 2 * qd;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        *reinterpret_cast<uint32_t*>(dkr + nn * 8) =
            pack_bf16(dk[4 * nn + 2 * r], dk[4 * nn + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvr + nn * 8) =
            pack_bf16(dv[4 * nn + 2 * r], dv[4 * nn + 2 * r + 1]);
      }
    }
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
cudaError_t launch_wgmma(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_wgmma_smem_bytes<D>();
  constexpr size_t smem_kv = dkdv_wgmma_smem_bytes<D>();
  static_assert(smem_dq <= 232448 && smem_kv <= 232448, "more than 227 KB");
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      fa_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_dq));
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      fa_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_kv != cudaSuccess) return attr_kv;
  // each tensor twice: in 128-row boxes for the tiles an item keeps, in
  // 64-row boxes for the tiles streamed through the ring
  BwdTma t;
  CUtensorMap tq128, tdo128, tk64, tv64, tk128, tv128, tq64, tdo64;
  if (!map_bhsd(&tq128, p.q, batch, p.hq, p.sq, D, p.q_sb, p.q_sh, p.q_ss,
                kWRows, &t.q_s_first) ||
      !map_bhsd(&tq64, p.q, batch, p.hq, p.sq, D, p.q_sb, p.q_sh, p.q_ss,
                kWTile, &t.q_s_first) ||
      !map_bhsd(&tdo128, p.dout, batch, p.hq, p.sq, D, p.do_sb, p.do_sh,
                p.do_ss, kWRows, &t.do_s_first) ||
      !map_bhsd(&tdo64, p.dout, batch, p.hq, p.sq, D, p.do_sb, p.do_sh,
                p.do_ss, kWTile, &t.do_s_first) ||
      !map_bhsd(&tk128, p.k, batch, p.hkv, p.skv, D, p.k_sb, p.k_sh, p.k_ss,
                kWRows, &t.k_s_first) ||
      !map_bhsd(&tk64, p.k, batch, p.hkv, p.skv, D, p.k_sb, p.k_sh, p.k_ss,
                kWTile, &t.k_s_first) ||
      !map_bhsd(&tv128, p.v, batch, p.hkv, p.skv, D, p.v_sb, p.v_sh, p.v_ss,
                kWRows, &t.v_s_first) ||
      !map_bhsd(&tv64, p.v, batch, p.hkv, p.skv, D, p.v_sb, p.v_sh, p.v_ss,
                kWTile, &t.v_s_first))
    return cudaErrorInvalidValue;
  t.batch = batch;
  t.stat_blocks = 2 * ((p.sq + kWRows - 1) / kWRows);
  const int n_sm = sm_count();
  // dQ first: it writes the row statistics that dK/dV reads
  t.n_tiles = (p.sq + kWRows - 1) / kWRows;
  t.n_items = t.n_tiles * p.hq * batch;
  fa_bwd_dq_wgmma<D><<<t.n_items < n_sm ? t.n_items : n_sm, 288, smem_dq, stream>>>(
      tq128, tdo128, tk64, tv64, p, t);
  const cudaError_t e = counted(cudaGetLastError(), kDqWgmma);
  if (e != cudaSuccess) return e;
  t.n_tiles = (p.skv + kWRows - 1) / kWRows;
  t.n_items = t.n_tiles * p.hkv * batch;
  fa_bwd_dkdv_wgmma<D><<<t.n_items < n_sm ? t.n_items : n_sm, 384, smem_kv, stream>>>(
      tk128, tv128, tq64, tdo64, p, t);
  return counted(cudaGetLastError(), kDkdvWgmma);
}

template <int D>
cudaError_t launch_d(const BwdParams& p, int batch, int variant, cudaStream_t s) {
  if (variant == kVarWgmma) {
    if constexpr (D == 64 || D == 128) {
      return launch_wgmma<D>(p, batch, s);
    } else {
      return cudaErrorInvalidValue;  // no wgmma instance at this head dim
    }
  }
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

// variant: 0 = fa_bwd_simt (float32 tensors), 1 = fa_bwd_bf16_mma, 2 =
// fa_bwd_wgmma (bfloat16 tensors; head dims 64 and 128), chosen by the
// wrapper.  q, k, v, o and dout come with their strides in elements (the last
// dimension of each has stride 1; for bfloat16 every base and every row start
// is on a 16-byte boundary); lse [B, Hq, Sq] fp32 contiguous is the
// forward's; delta is fp32 scratch: [B, Hq, Sq] delta for variants 0 and 1,
// for variant 2 the row statistics [B, Hq, Sq rounded up to 128 / 64, 2, 64]
// (lse in base 2, then delta, 64 rows a block).  dq [B, Hq, Sq, D] and dk, dv
// [B, Hkv, Skv, D] are written contiguous, in the inputs' type.  Launches
// fa_bwd_delta, then the dK/dV kernel, then the dQ kernel (variants 0, 1), or
// fa_bwd_dq_wgmma then fa_bwd_dkdv_wgmma (variant 2), on `stream`.  Returns
// the first failing launch's cudaError_t as an int (0 = success;
// cudaErrorInvalidValue for a head dim or variant that has no kernel, or a
// tensor the driver refuses to map).
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
  if (variant != kVarSimt && variant != kVarMma && variant != kVarWgmma)
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
