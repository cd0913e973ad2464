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
// by bytes.  The bf16 path therefore runs both products on the tensor cores
// (`mma.sync.m16n8k16`, fp32 accumulate) and keeps the probabilities in
// registers between the two products; K and V tiles arrive in shared memory by
// `cp.async` while the previous tile is computed on.  The fp32 path has to
// keep full fp32 products (TF32 would lose the 2e-5 agreement with the plain
// version), so it runs on the fp32 pipes with a 4x4 register micro-tile per
// thread.
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
// The C interface at the end returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "../../csrc/hopper_mma.cuh"

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;  // masked logit, as the TPU kernel's
constexpr int BN = 64;                      // kv rows per tile

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim has stride 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;        // <= 0: no window
  float scale_log2;  // log2(e) / sqrt(D)
};

// Range [lo, hi) of kv tiles that hold any visible key for this q tile.
__device__ __forceinline__ void kv_tile_range(const FaParams& p, int q_start,
                                              int bm, int* lo, int* hi) {
  const int n_tiles = (p.skv + BN - 1) / BN;
  const int q_last = min(q_start + bm, p.sq) - 1;
  int h = n_tiles;
  if (p.causal) h = min(h, q_last / BN + 1);
  int l = 0;
  if (p.window > 0) l = max(0, (q_start - p.window + 1) / BN);
  *lo = l;
  *hi = h;
}

// True when every (q, k) pair of the tile is visible, so masking can be skipped.
__device__ __forceinline__ bool tile_is_full(const FaParams& p, int q_start,
                                             int bm, int k_start) {
  if (k_start + BN > p.skv) return false;
  if (p.causal && k_start + BN - 1 > q_start) return false;
  if (p.window > 0 && q_start + bm - 1 - k_start >= p.window) return false;
  return true;
}

__device__ __forceinline__ bool visible(const FaParams& p, int qpos, int kpos) {
  bool ok = kpos < p.skv;
  if (p.causal) ok = ok && (qpos >= kpos);
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
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
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + qpos * p.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <void (*Kernel)(FaParams), int kThreads, size_t kSmem>
cudaError_t launch(const FaParams& p, int batch, cudaStream_t stream) {
  // More than 48 KB of dynamic shared memory has to be asked for: once for
  // each kernel, so the static is one per instance of this template.
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + 63) / 64, p.hq, batch);  // both kernels: 64 q rows
  Kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const FaParams& p, int batch, int is_bf16,
                     cudaStream_t stream) {
  if (is_bf16) {
    constexpr size_t smem = sizeof(__nv_bfloat16) * (64 + 4 * BN) * (D + 8);
    return launch<fa_fwd_bf16_mma<D>, 128, smem>(p, batch, stream);
  }
  constexpr size_t smem =
      sizeof(float) * ((64 + BN) * (D + 1) + BN * D + 64 * (BN + 4));
  return launch<fa_fwd_simt<D>, 256, smem>(p, batch, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor has stride 1.  For bfloat16 every pointer and every
// row start must be 16-byte aligned.  Returns the launch's cudaError_t as an
// int (0 = success, 1 = unsupported head dim or dtype).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      int batch, int hq, int hkv, int sq, int skv, int d,
                      long long q_sb, long long q_sh, long long q_ss,
                      long long k_sb, long long k_sh, long long k_ss,
                      long long v_sb, long long v_sh, long long v_ss,
                      long long o_sb, long long o_sh, long long o_ss,
                      int causal, int window, float scale_log2, int dtype,
                      void* stream) {
  FaParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal; p.window = window; p.scale_log2 = scale_log2;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return static_cast<int>(launch_d<32>(p, batch, dtype, s));
    case 64: return static_cast<int>(launch_d<64>(p, batch, dtype, s));
    case 80: return static_cast<int>(launch_d<80>(p, batch, dtype, s));
    case 128: return static_cast<int>(launch_d<128>(p, batch, dtype, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
