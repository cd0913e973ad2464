// Flash-attention forward for NVIDIA Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention/kernel.py (launched by
// `flash_attention_fwd`, public wrapper `ops.flash_attention`): it computes
// softmax(Q K^T / sqrt(D) + mask) V by online softmax over (q tile x kv tile)
// blocks, with causal, sliding-window and ragged-tail masks, and gives 0 for a
// row that sees no key.
//
// What bounds it on this card.  Each input is read once and the output
// written once, so at a prefill shape (Sq = Skv in the thousands, D = 64) the
// kernel does hundreds of operations per byte: it is bound by operations, not
// by bytes.  Three kernels, the one that runs fixed by (dtype, head dim); the
// rule is the wrapper's `kernel.variant()`, which passes its choice in:
//  * `fa_fwd_wgmma`, bf16 at head dims 64 and 128 (tinyllama-1.1b;
//    llama3.2-3b, nemotron-4-15b): Hopper's own path to the tensor cores.
//    A persistent grid (one block per SM, whose fixed cost is then paid
//    once, not per q tile); two warpgroups share each K/V tile (128 q rows
//    an item, 128 kv rows a tile) and run free of each other, so one
//    runs its softmax while the other's product runs; a producer warp keeps
//    a TMA ring of K and V filled; both products are wgmma and the
//    probabilities never leave registers.  The softmax and the products of
//    one warpgroup do not overlap: issuing Q K^T of the next tile with P V
//    of this one measured slower at head dim 64, with the wgmma kept
//    pipelined or not (PERF.md).
//  * `fa_fwd_bf16_mma`, bf16 at head dims 32 and 80 (stablelm-3b: 160-byte
//    rows, which the 128-byte swizzle does not tile): both products on
//    `mma.sync.m16n8k16` (fp32 accumulate) with the probabilities in
//    registers; K and V tiles arrive by `cp.async` while the previous tile
//    is computed on.
//  * `fa_fwd_simt`, fp32: full fp32 products (TF32 would lose the 2e-5
//    agreement with the plain version) on the fp32 pipes with a 4x4 register
//    micro-tile per thread.
//
// What the design changes against the TPU kernel.  There the kv tile index is
// the minor, sequential grid axis and acc/m/l live in VMEM scratch between
// grid steps.  Here one thread block owns one (batch, head, q tile) and loops
// over the kv tiles itself; acc/m/l live in registers.  Skipping fully masked
// tiles becomes the loop's bounds.  Grouped-query attention is an index
// (`kv_head = head / (Hq / Hkv)`), not a repeat of K and V.  Ragged tails are
// zero-filled loads and masked logits, not padding.  Q, K and V come with
// their strides, so a [B, S, H, D] projection viewed as [B, H, S, D] needs no
// copy.
//
// Training asks each kernel for the log-sum-exp of every row as well (a
// non-null `lse`, [B, Hq, Sq] fp32): lse = m + log(l) in natural-log units of
// the scaled logits, which the backward (flash_bwd.cu) needs to recompute the
// probabilities.  The kernels keep m in base 2 (the scale passed in is
// log2(e)/sqrt(D)), so each converts with ln(2).  A row that sees no key has
// l = 0 (every visible logit adds at least exp(0) = 1 at the row's maximum)
// and gets lse = kNegInf, the finite masked logit, as the JAX package's
// blocked forward gives it (its log(1e-30) vanishes in the rounding).  With a
// null `lse` nothing is written: serving runs the same code as before.
//
// The C interface at the end returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue when the driver refuses a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "../../csrc/hopper_mma.cuh"
#include "../../csrc/hopper_sm90.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;  // masked logit, as the TPU kernel's
constexpr int BN = 64;                      // kv rows per tile

// The kernels, by the codes of kernel.VARIANT_CODES (a test holds the two to
// each other): the wrapper's variant() chooses one and passes its code.
enum FaVariant {
  kSimt = 0,   // fa_fwd_simt
  kMma = 1,    // fa_fwd_bf16_mma
  kWgmma = 2,  // fa_fwd_wgmma
  kNumKernels
};
const char* const kKernelNames[kNumKernels] = {"fa_fwd_simt", "fa_fwd_bf16_mma",
                                               "fa_fwd_wgmma"};
// The launches of each kernel since the library was loaded, counted at the
// launch itself once it succeeded (read through fa_kernel_launches), so a
// caller can see which kernel a call really ran.
long long g_launches[kNumKernels] = {};

cudaError_t counted(cudaError_t e, FaVariant kernel) {
  if (e == cudaSuccess) ++g_launches[kernel];
  return e;
}

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;        // [B, Hq, Sq] contiguous, or null: not asked for
  int hq, hkv, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim has stride 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // log2(e) / sqrt(D)
};

// Range [lo, hi) of kv tiles of TBN rows that hold any visible key for the
// q rows [q_start, q_start + bm).
template <int TBN = BN>
__device__ __forceinline__ void kv_tile_range(const FaParams& p, int q_start,
                                              int bm, int* lo, int* hi) {
  const int n_tiles = (p.skv + TBN - 1) / TBN;
  const int q_last = min(q_start + bm, p.sq) - 1;
  int h = n_tiles;
  if (p.causal) h = min(h, q_last / TBN + 1);
  int l = 0;
  if (p.window > 0) l = max(0, (q_start - p.window + 1) / TBN);
  *lo = l;
  *hi = h;
}

// True when every (q, k) pair of the tile is visible, so masking can be skipped.
template <int TBN = BN>
__device__ __forceinline__ bool tile_is_full(const FaParams& p, int q_start,
                                             int bm, int k_start) {
  if (k_start + TBN > p.skv) return false;
  if (p.causal && k_start + TBN - 1 > q_start) return false;
  if (p.window > 0 && q_start + bm - 1 - k_start >= p.window) return false;
  return true;
}

__device__ __forceinline__ bool visible(const FaParams& p, int qpos, int kpos) {
  bool ok = kpos < p.skv;
  if (p.causal) ok = ok && (qpos >= kpos);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
}

// Writes row qpos's log-sum-exp when it was asked for.  m2 is the row's
// maximum in base-2 units of the scaled logit, l its sum of 2^(x - m2).
__device__ __forceinline__ void store_lse(const FaParams& p, int b, int h,
                                          int qpos, float m2, float l) {
  if (p.lse == nullptr) return;
  constexpr float kLn2 = 0.6931471805599453f;
  p.lse[(static_cast<long long>(b) * p.hq + h) * p.sq + qpos] =
      l > 0.f ? m2 * kLn2 + logf(l) : kNegInf;
}

// ---------------------------------------------------------------------------
// fp32 path: full-precision products on the fp32 pipes.
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty*4 .. ty*4+3 and the
// columns tx + 16*j of the logits tile and of the output.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256) fa_fwd_simt(FaParams p) {
  constexpr int BM = 64;       // q rows per block
  constexpr int LDQ = D + 1;   // odd row stride: column reads hit distinct banks
  constexpr int LDP = BN + 4;  // the two row groups of a warp land 16 banks apart
  constexpr int NJ = BN / 16;  // logit columns per thread
  constexpr int ND = D / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BM][LDQ]
  float* Ks = Qs + BM * LDQ;                       // [BN][LDQ]
  float* Vs = Ks + BN * LDQ;                       // [BN][D]
  float* Ps = Vs + BN * D;                         // [BM][LDP]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_start = q_tile * BM;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BM * D; i += 256) {
    const int r = i / D, d = i % D;
    const int qpos = q_start + r;
    Qs[r * LDQ + d] = qpos < p.sq ? qg[qpos * p.q_ss + d] : 0.f;
  }

  float acc[4][ND];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }

  int lo, hi;
  kv_tile_range(p, q_start, BM, &lo, &hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k_start = kt * BN;
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = tid; i < BN * D; i += 256) {
      const int r = i / D, d = i % D;
      const int kpos = k_start + r;
      const bool in = kpos < p.skv;
      Ks[r * LDQ + d] = in ? kg[kpos * p.k_ss + d] : 0.f;
      Vs[r * D + d] = in ? vg[kpos * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    const bool full = tile_is_full(p, q_start, BM, k_start);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + ty * 4 + i;
      bool vis[NJ];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        vis[j] = full || visible(p, qpos, k_start + tx + 16 * j);
        s[i][j] = vis[j] ? s[i][j] * p.scale_log2 : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads that share this row are one half of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: every logit is
      const float corr = (m[i] == -INFINITY) ? 0.f : exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pv = vis[j] ? exp2f(s[i][j] - m_new) : 0.f;
        sum += pv;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
    }
    // rows ty*4 .. ty*4+3 of Ps are written and read by the same half warp
    __syncwarp();

#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float pv[4], vv[ND];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + n];
#pragma unroll
      for (int j = 0; j < ND; ++j) vv[j] = Vs[n * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncwarp();  // Ps is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + ty * 4 + i;
    if (qpos >= p.sq) continue;
    if (tx == 0) store_lse(p, b, h, qpos, m[i], l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      og[qpos * p.o_ss + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 path: both products on the tensor cores (mma.sync m16n8k16, fp32
// accumulate).  128 threads = 4 warps; warp w owns q rows w*16 .. w*16+15 of
// the block's 64.  In the fragment layouts below g = lane / 4, t = lane % 4.
// (Measured on an H100: 32 rows a warp, or 8 warps a block, halve the K/V
// traffic from L2 but cost registers or occupancy and gain nothing at
// D = 64, Sq = 1024; see PERF.md.)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128) fa_fwd_bf16_mma(FaParams p) {
  // +8 elements (16 bytes) of padding: the 8 rows that one fragment load or
  // one ldmatrix phase touches fall into distinct banks, and rows stay
  // 16-byte aligned.
  constexpr int LD = D + 8;
  constexpr int BM = 64;       // q rows per block
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int NS = BN / 8;   // n-tiles of the logits
  constexpr int NO = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LD]
  __nv_bfloat16* Ks = Qs + BM * LD;      // [2][BN][LD]
  __nv_bfloat16* Vs = Ks + 2 * BN * LD;  // [2][BN][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q_tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const int q_start = q_tile * BM;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  int lo, hi;
  kv_tile_range(p, q_start, BM, &lo, &hi);

  // Q and the first K/V tile
  load_tile_async<BM, D, LD>(Qs, qg, p.q_ss, q_start, p.sq, tid);
  if (lo < hi) {
    load_tile_async<BN, D, LD>(Ks, kg, p.k_ss, lo * BN, p.skv, tid);
    load_tile_async<BN, D, LD>(Vs, vg, p.v_ss, lo * BN, p.skv, tid);
  }
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // rows g and g + 8 of the warp's 16; m is in units of the raw logit
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int kt = lo; kt < hi; ++kt) {
    const int buf = (kt - lo) & 1;
    const int k_start = kt * BN;
    const __nv_bfloat16* Kb = Ks + buf * BN * LD;
    const __nv_bfloat16* Vb = Vs + buf * BN * LD;

    // Tile kt (and, the first time, Q) has arrived; and since every warp is
    // here, none still computes on tile kt - 1, so its buffer is free for the
    // copy of tile kt + 1, which then runs while this tile is computed on.
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < hi) {
      load_tile_async<BN, D, LD>(Ks + (buf ^ 1) * BN * LD, kg, p.k_ss,
                                 (kt + 1) * BN, p.skv, tid);
      load_tile_async<BN, D, LD>(Vs + (buf ^ 1) * BN * LD, vg, p.v_ss,
                                 (kt + 1) * BN, p.skv, tid);
      cp_async_commit();
    }

    if (kt == lo) {
      // A fragments of Q: a0 (row g, k 2t..), a1 (row g+8), a2 (row g, k 8+2t..),
      // a3 (row g+8, k 8+2t..)
      const __nv_bfloat16* qrow = Qs + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(qrow + kk * 16);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(qrow + 8 * LD + kk * 16);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8);
        qf[kk][3] =
            *reinterpret_cast<const uint32_t*>(qrow + 8 * LD + kk * 16 + 8);
      }
    }

    // S = Q K^T.  B fragment of K^T for logit n-tile n and k-step kk:
    // b0 = K[n*8 + g][kk*16 + 2t, +1], b1 = the same row, 8 further along D.
    // One ldmatrix.x4 brings b0, b1 for n-tile 2*np and for n-tile 2*np + 1:
    // lane i gives the row address of row i % 8 of matrix i / 8.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, Kb + ((2 * np + lane / 16) * 8 + lane % 8) * LD +
                           kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // C fragment: c0, c1 = (row g, cols n*8 + 2t, +1); c2, c3 = row g + 8.
    const bool full = tile_is_full(p, q_start, BM, k_start);
    const int qrow0 = q_start + warp * 16 + g;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full) {
          const int qpos = qrow0 + (e >> 1) * 8;
          const int kpos = k_start + n * 8 + 2 * t + (e & 1);
          if (!visible(p, qpos, kpos)) s[n][e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    // The scale rides in the exponent's multiply-add:
    // p = 2^(s * scale - m * scale).
    float corr[2], m_scaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: every logit is
      corr[r] = (m[r] == -INFINITY)
                    ? 0.f
                    : fast_exp2((m[r] - m_new) * p.scale_log2);
      m[r] = m_new;
      m_scaled[r] = m_new * p.scale_log2;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked logit is exactly kNegInf; a visible one never is
        const float pv =
            (s[n][e] == kNegInf)
                ? 0.f
                : fast_exp2(fmaf(s[n][e], p.scale_log2, -m_scaled[e >> 1]));
        s[n][e] = pv;
        sum[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V.  The C fragments of two neighbouring logit n-tiles are the A
    // fragment of one 16-wide k-step.  B fragments of V come transposed out of
    // shared memory: one ldmatrix.x4.trans gives b0, b1 for output n-tile 2*nd
    // and b0, b1 for n-tile 2*nd + 1.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, Vb + (kk * 16 + (lane % 16)) * LD + nd * 16 + (lane / 16) * 8);
        mma_bf16_16816(o[2 * nd], a, r[0], r[1]);
        mma_bf16_16816(o[2 * nd + 1], a, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q_start + warp * 16 + g + r * 8;
    if (qpos >= p.sq) continue;
    if (t == 0) store_lse(p, b, h, qpos, m[r] * p.scale_log2, l[r]);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + qpos * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path at head dims 64 and 128: wgmma and TMA (hopper_sm90.cuh).  A
// persistent grid, one block per SM, walks the list of (q tile, head, batch)
// items, longest causal rows first, the block taking every gridDim-th item.
// 288 threads: two consumer warpgroups and one producer warp.  Consumer
// warpgroup wg owns the item's q rows wg*64 .. wg*64+63; both share every K/V
// tile of 128 rows, which the producer warp brings by TMA into a ring of
// kv_stages() stages (128-byte swizzle, one mbarrier each for K and for V,
// one for the consumers' release), running on into the next item while the
// consumers finish this one; Q has two buffers for the same reason.  S = Q
// K^T is wgmma with both operands in shared memory (K-major, as stored); the
// softmax runs on the accumulator in registers; P, rounded to bf16, stays in
// registers as the A operand of O += P V, whose B operand V is MN-major
// (transpose bit set).  The two warpgroups run free of each other, so the
// tensor cores serve one while the other runs its softmax: turns taken on
// named barriers ("ping-pong") measured 4.5 % slower at both head dims
// (PERF.md).  The masks, the scale folded into ex2, masked logits exactly
// kNegInf, l clamped at 1e-30 and exact 0 for a row that sees no key are the
// mma.sync kernel's.
// ---------------------------------------------------------------------------

constexpr int WBM = 128;  // q rows per item
constexpr int WBN = 128;  // kv rows per tile

template <int D>
__host__ __device__ constexpr int kv_stages() {
  return D == 64 ? 3 : 2;  // what fits beside two Q buffers in 227 KB
}

struct FaTma {
  int n_q_tiles, batch;
  // 1 when dimension 1 of the tensor's map is the sequence, 0 when the head
  // (the two are ordered by stride; see map_bhsd)
  int q_s_first, k_s_first, v_s_first;
};

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // alignment slack; Q, two buffers of [128][D]; K and V, kv_stages() stages
  // of [128][D] each; barriers
  return 1024 + sizeof(__nv_bfloat16) * (2 * WBM * D + 2 * kv_stages<D>() * WBN * D) +
         8 * (4 + 3 * kv_stages<D>());
}

// Item j of the list: q tiles slowest and longest first, then batch, then head.
struct FaItem {
  int q_start, h, b, lo, hi;
};
__device__ __forceinline__ FaItem fa_item(const FaParams& p, const FaTma& t,
                                          int j) {
  const int bh = p.hq * t.batch;
  FaItem it;
  it.q_start = (t.n_q_tiles - 1 - j / bh) * WBM;
  it.h = j % p.hq;
  it.b = (j % bh) / p.hq;
  kv_tile_range<WBN>(p, it.q_start, WBM, &it.lo, &it.hi);
  return it;
}

template <int D>
__global__ void __launch_bounds__(288, 1)
    fa_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, FaParams p,
                 FaTma t) {
  using bf16 = __nv_bfloat16;
  constexpr int NA = D / 64;     // 64-column atoms of a row
  constexpr int KD = D / 16;     // k-steps of Q K^T
  constexpr int KN = WBN / 16;   // k-steps of P V
  constexpr int NS = WBN / 8;    // 8-column groups of the logits
  constexpr int ST = kv_stages<D>();
  constexpr uint32_t TILE = WBN * D * sizeof(bf16);
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));  // [2][NA][128][64]
  bf16* Ks = Qs + 2 * WBM * D;                               // [ST][NA][128][64]
  bf16* Vs = Ks + ST * WBN * D;                              // [ST][NA][128][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + ST * WBN * D);
  uint64_t* q_full = bars;               // [2]
  uint64_t* q_empty = bars + 2;          // [2], one arrival per consumer thread
  uint64_t* full_k = bars + 4;           // [ST]
  uint64_t* full_v = bars + 4 + ST;      // [ST]
  uint64_t* empty = bars + 4 + 2 * ST;   // [ST], one arrival per consumer thread

  const int tid = threadIdx.x;
  const int n_items = t.n_q_tiles * p.hq * t.batch;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 256);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp_id = warp_index();
  if (warp_id == 8) {
    // the producer warp; one lane issues every copy, item after item
    if (tid != 256) return;
    // rows [pos, pos + 128) of one head, every 64-column atom (tiles of Q, K
    // and V all have 128 rows)
    auto load = [&](const CUtensorMap* map, int s_first, bf16* dst,
                    uint64_t* bar, int pos, int head, int b) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_load_4d(dst + a * 128 * 64, map, bar, a * 64, s_first ? pos : head,
                    s_first ? head : pos, b);
    };
    int ring = 0;  // K/V tiles this block has loaded
    int n = 0;     // items this block has begun
    for (int j = blockIdx.x; j < n_items; j += gridDim.x, ++n) {
      const FaItem it = fa_item(p, t, j);
      const int hk = it.h / (p.hq / p.hkv);
      const int qb = n & 1;
      if (n >= 2) mbar_wait(q_empty + qb, (n / 2 - 1) & 1);
      mbar_expect_tx(q_full + qb, WBM * D * sizeof(bf16));
      load(&tq, t.q_s_first, Qs + qb * WBM * D, q_full + qb, it.q_start, it.h, it.b);
      for (int kt = it.lo; kt < it.hi; ++kt, ++ring) {
        const int s = ring % ST;
        if (ring >= ST) mbar_wait(empty + s, (ring / ST - 1) & 1);
        mbar_expect_tx(full_k + s, TILE);
        load(&tk, t.k_s_first, Ks + s * WBN * D, full_k + s, kt * WBN, hk, it.b);
        mbar_expect_tx(full_v + s, TILE);
        load(&tv, t.v_s_first, Vs + s * WBN * D, full_v + s, kt * WBN, hk, it.b);
      }
    }
    return;
  }

  const int wg = warp_id / 4, warp = warp_id % 4, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  int ring = 0, n = 0;
  for (int j = blockIdx.x; j < n_items; j += gridDim.x, ++n) {
    const FaItem it = fa_item(p, t, j);
    const int n_tiles = it.hi - it.lo;  // 0 or less: no row sees a key
    const int qb = n & 1;
    const bf16* Qw = Qs + qb * WBM * D + wg * 64 * 64;  // this warpgroup's rows
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // rows g and g + 8 of the warp's 16; m is in units of the raw logit
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    const int qw_start = it.q_start + wg * 64;
    const int row0 = qw_start + warp * 16 + g;
    mbar_wait(q_full + qb, (n / 2) & 1);

    for (int i = 0; i < n_tiles; ++i, ++ring) {
      const int s = ring % ST;
      const uint32_t ph = (ring / ST) & 1;
      const int k_start = (it.lo + i) * WBN;
      const bf16* Kt = Ks + s * WBN * D;

      // S = Q K^T; the first k-step only writes the accumulator
      float sc[WBN / 2];
      mbar_wait(full_k + s, ph);
      wgmma_fence();
      wgmma_ss_n128_first<0, 0>(sc, sw128_desc(Qw, 16, 1024),
                                sw128_desc(Kt, 16, 1024));
#pragma unroll
      for (int kk = 1; kk < KD; ++kk) {
        const int off = (kk / 4) * 128 * 64 + (kk % 4) * 16;
        wgmma_ss_n128<0, 0>(sc, sw128_desc(Qw + off, 16, 1024),
                            sw128_desc(Kt + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // sc[4n + e]: row row0 + 8 (e / 2), column k_start + 8n + 2qd + e % 2
      const bool full = tile_is_full<WBN>(p, qw_start, 64, k_start);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nn = 0; nn < NS; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full) {
            const int qpos = row0 + (e >> 1) * 8;
            const int kpos = k_start + nn * 8 + 2 * qd + (e & 1);
            if (!visible(p, qpos, kpos)) sc[4 * nn + e] = kNegInf;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * nn + e]);
        }
      }
      float corr[2], m_scaled[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the 4 threads of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);  // finite: every logit is
        corr[r] = (m[r] == -INFINITY)
                      ? 0.f
                      : fast_exp2((m[r] - m_new) * p.scale_log2);
        m[r] = m_new;
        m_scaled[r] = m_new * p.scale_log2;
      }
      float sum[2] = {0.f, 0.f};
      // P as the bf16 A fragments of the 8 k-steps of P V
      uint32_t pa[KN][4];
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        float pv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float x = sc[8 * kk + e];
          // a masked logit is exactly kNegInf; a visible one never is
          pv[e] = (x == kNegInf)
                      ? 0.f
                      : fast_exp2(fmaf(x, p.scale_log2, -m_scaled[(e >> 1) & 1]));
          sum[(e >> 1) & 1] += pv[e];
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) pa[kk][f] = pack_bf16(pv[2 * f], pv[2 * f + 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];

      // O += P V
      mbar_wait(full_v + s, ph);
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) fence_regs(pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        // rows 16kk .. 16kk + 15 of V; the second atom (D = 128) is LBO away
        const uint64_t dv = sw128_desc(Vs + s * WBN * D + kk * 16 * 64, WBN * 128, 1024);
        if constexpr (D == 64) {
          wgmma_rs_n64<1>(o, pa[kk], dv, 1);
        } else {
          wgmma_rs_n128<1>(o, pa[kk], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      // P's registers stay P's until the product that reads them is done
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) fence_regs(pa[kk]);
      mbar_arrive(empty + s);  // this thread is done with stage s
    }
    mbar_arrive(q_empty + qb);  // and with this item's Q

    bf16* og = static_cast<bf16*>(p.o) + it.b * p.o_sb + it.h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + r * 8;
      if (qpos >= p.sq) continue;
      if (qd == 0) store_lse(p, it.b, it.h, qpos, m[r] * p.scale_log2, l[r]);
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      bf16* orow = og + qpos * p.o_ss + 2 * qd;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        *reinterpret_cast<uint32_t*>(orow + nn * 8) =
            pack_bf16(o[4 * nn + 2 * r] * inv, o[4 * nn + 2 * r + 1] * inv);
      }
    }
  }
}

template <void (*Kernel)(FaParams), FaVariant kWhich, int kThreads, size_t kSmem>
cudaError_t launch(const FaParams& p, int batch, cudaStream_t stream) {
  // More than 48 KB of dynamic shared memory has to be asked for: once for
  // each kernel, so the static is one per instance of this template.
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + 63) / 64, p.hq, batch);  // both kernels: 64 q rows
  Kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return counted(cudaGetLastError(), kWhich);
}

template <int D>
cudaError_t launch_wgmma(const FaParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = wgmma_smem_bytes<D>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  FaTma t;
  CUtensorMap tq, tk, tv;
  if (!map_bhsd(&tq, p.q, batch, p.hq, p.sq, D, p.q_sb, p.q_sh, p.q_ss, WBM,
                &t.q_s_first) ||
      !map_bhsd(&tk, p.k, batch, p.hkv, p.skv, D, p.k_sb, p.k_sh, p.k_ss, WBN,
                &t.k_s_first) ||
      !map_bhsd(&tv, p.v, batch, p.hkv, p.skv, D, p.v_sb, p.v_sh, p.v_ss, WBN,
                &t.v_s_first))
    return cudaErrorInvalidValue;
  t.n_q_tiles = (p.sq + WBM - 1) / WBM;
  t.batch = batch;
  // one block per SM (168 registers a thread allow no second), none idle
  const int n_sm = sm_count();
  const long long n_items = static_cast<long long>(t.n_q_tiles) * p.hq * batch;
  const unsigned grid = static_cast<unsigned>(n_items < n_sm ? n_items : n_sm);
  fa_fwd_wgmma<D><<<grid, 288, smem, stream>>>(tq, tk, tv, p, t);
  return counted(cudaGetLastError(), kWgmma);
}

template <int D>
cudaError_t launch_d(const FaParams& p, int batch, int variant,
                     cudaStream_t stream) {
  if (variant == kWgmma) {
    if constexpr (D == 64 || D == 128) {
      return launch_wgmma<D>(p, batch, stream);
    } else {
      return cudaErrorInvalidValue;  // no wgmma instance at this head dim
    }
  }
  if (variant == kMma) {
    constexpr size_t smem = sizeof(__nv_bfloat16) * (64 + 4 * BN) * (D + 8);
    return launch<fa_fwd_bf16_mma<D>, kMma, 128, smem>(p, batch, stream);
  }
  constexpr size_t smem =
      sizeof(float) * ((64 + BN) * (D + 1) + BN * D + 64 * (BN + 4));
  return launch<fa_fwd_simt<D>, kSimt, 256, smem>(p, batch, stream);
}

}  // namespace

// variant: the kernel to launch, chosen by the wrapper from dtype and head
// dim: 0 = fa_fwd_simt (float32 tensors), 1 = fa_fwd_bf16_mma, 2 =
// fa_fwd_wgmma (bfloat16 tensors).  Strides are in elements; the last
// dimension of every tensor has stride 1.  For bfloat16 every pointer and every
// row start must be 16-byte aligned.  `lse`: null, or a contiguous [B, Hq, Sq]
// fp32 buffer that receives each row's log-sum-exp.  Returns the launch's
// cudaError_t as an int (0 = success; cudaErrorInvalidValue for a head dim or
// variant that has no kernel).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int batch, int hq, int hkv, int sq, int skv, int d,
                      long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long o_sb, long long o_sh, long long o_ss,
                      int causal, int window, float scale_log2, int variant,
                      void* stream) {
  FaParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lse = static_cast<float*>(lse);
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.scale_log2 = scale_log2;
  if (variant != kSimt && variant != kMma && variant != kWgmma)
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
extern "C" const char* fa_kernel_name(int i) {
  return (i >= 0 && i < kNumKernels) ? kKernelNames[i] : nullptr;
}
extern "C" long long fa_kernel_launches(int i) {
  return (i >= 0 && i < kNumKernels) ? g_launches[i] : -1;
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
