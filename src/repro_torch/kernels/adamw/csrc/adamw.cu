// AdamW's global norm and update for NVIDIA Hopper (sm_90a), hand-written
// CUDA C++ (K4).
//
// Replaces no Pallas kernel: the JAX package's `adamw_update`
// (src/repro/optim/adamw.py) is jnp, which XLA fuses into a few passes over
// each leaf.  In eager PyTorch the same expressions are some 26 full fp32
// passes through device memory a leaf (the plain version, ../ref.py), about
// 200 bytes a parameter.  Two CUDA kernels take every leaf of the optimizer
// in one launch each:
//
// adamw_sumsq: the sum of every gradient element's square.  A persistent
//   grid walks the leaves in fixed-size chunks (kChunk elements), so the
//   large leaves spread over every SM and the small ones ride in the same
//   launch.  Each chunk's sum goes to one fp32 partial; the last block to
//   finish (an integer counter, no float atomics) sums each leaf's partials
//   and then the leaves, in one fixed order, and writes the total and its
//   square root.  A chunk's sum depends on its elements alone, so repeated
//   runs are bit-equal.
//
// adamw_update: one pass over every leaf: g, p, m and v read once, p, m and v
//   written once, nothing in between in device memory (28 bytes a parameter
//   with the norm's read of fp32 g: the bound).  It computes the plain
//   version's fp32 expression in its order, each product rounded on its own
//   (built with -fmad=false), division and square root IEEE-rounded, and
//   rounds the param to its type to nearest-even, so given the same scalars
//   it gives the plain version's bits.  scale, lr, b1t and b2t are read from
//   device memory, so nothing waits on the host.
//
// Both are bound by device memory.  Loads are 16 bytes a thread where every
// pointer of a leaf is 16-byte aligned (8 elements: one load of bf16, two of
// fp32); a leaf with an unaligned pointer (a mesh shard can be an offset
// view) takes a scalar path.  Each leaf has its own (param, grad) types,
// bf16 or fp32 (kGradBf16, kParamBf16), so one launch takes every leaf
// whatever its types.
// The leaf table goes in as a __grid_constant__ kernel argument, so no table
// is copied to the device; a launch takes up to kMaxLeaves leaves.
//
// The C interface at the end returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 1 << 16;    // elements a chunk (kernel.CHUNK)
constexpr int kMaxLeaves = 128;    // leaves a launch (kernel.MAX_LEAVES)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;            // elements a thread loads at once
constexpr unsigned kFull = 0xffffffffu;

// the launches of each kernel since the library was loaded, counted at the
// launch itself once it succeeded (read through adamw_kernel_launches)
enum AdamwKernel { kSumsq, kUpdate, kNumKernels };
const char* const kKernelNames[kNumKernels] = {"adamw_sumsq", "adamw_update"};
long long g_launches[kNumKernels] = {};

// a leaf's types, by the code the C functions take (kernel.kind)
constexpr int kGradBf16 = 1;
constexpr int kParamBf16 = 2;

struct Leaf {
  const void* g;
  void* p;          // the update's: null for the norm
  float* m;
  float* v;
  long long n;      // elements
  int chunk0;       // the launch's index of the leaf's first chunk
  int kind;         // kGradBf16 | kParamBf16
  int vec;          // every pointer 16-byte aligned
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int leaves;
  int chunks;
};

struct Hyper {
  float b1, c1, b2, c2, eps, wd;   // c1 = 1 - b1, c2 = 1 - b2, as fp32
};

// the leaf that chunk c belongs to: the last whose first chunk is <= c
__device__ __forceinline__ int leaf_of(const Table& t, int c) {
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // element 2j is the low half of word j
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
  uint4 u;
  u.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  u.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  u.z = bf16_bits(x[4]) | (bf16_bits(x[5]) << 16);
  u.w = bf16_bits(x[6]) | (bf16_bits(x[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// lane 0 gets the warp's sum, always in the same order
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// the block's sum, in thread 0: each warp's, then the warps' in order
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
    s = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w];
  }
  __syncthreads();   // red is reused by the next chunk
  return s;
}

// this thread's share of the squares of g[lo, hi): vector k of the chunk
// goes to thread k % kThreads, its element j to accumulator j; the tail and
// the scalar path to accumulator 0; the accumulators then summed as a tree
template <typename G>
__device__ float chunk_sumsq(const G* g, long long lo, long long hi, bool vec) {
  float acc[kVec] = {};
  long long tail = lo;
  if (vec) {
    const int nvec = static_cast<int>((hi - lo) / kVec);
#pragma unroll 4
    for (int k = threadIdx.x; k < nvec; k += kThreads) {
      float x[kVec];
      load8(g + lo + static_cast<long long>(k) * kVec, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] += x[j] * x[j];
    }
    tail = lo + static_cast<long long>(nvec) * kVec;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    const float x = load1(g + e);
    acc[0] += x * x;
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

__global__ void __launch_bounds__(kThreads)
adamw_sumsq_kernel(const __grid_constant__ Table t, float* partials, unsigned* done,
                   float* out, int accumulate) {
  __shared__ float red[kWarps];
  __shared__ float leaf_sums[kMaxLeaves];
  __shared__ bool last;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const Leaf& f = t.leaf[leaf_of(t, c)];
    const long long lo = static_cast<long long>(c - f.chunk0) * kChunk;
    const long long hi = min(f.n, lo + kChunk);
    const float s = (f.kind & kGradBf16)
        ? chunk_sumsq(static_cast<const __nv_bfloat16*>(f.g), lo, hi, f.vec)
        : chunk_sumsq(static_cast<const float*>(f.g), lo, hi, f.vec);
    const float total = block_sum(s, red);
    if (threadIdx.x == 0) partials[c] = total;
  }
  // the last block to finish sums the partials: thread 0 of each block wrote
  // its partials, then fences them before it counts the block done
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a warp a leaf: lane j adds the leaf's partials j, j + 32, ... in order
  const int lane = threadIdx.x & 31;
  for (int l = threadIdx.x >> 5; l < t.leaves; l += kWarps) {
    const int c1 = l + 1 < t.leaves ? t.leaf[l + 1].chunk0 : t.chunks;
    float s = 0.f;
    for (int c = t.leaf[l].chunk0 + lane; c < c1; c += 32) s += __ldcg(partials + c);
    s = warp_sum(s);
    if (lane == 0) leaf_sums[l] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the leaves in order, after the sum of the launches before this one
    float s = accumulate ? out[0] : 0.f;
    for (int l = 0; l < t.leaves; ++l) s += leaf_sums[l];
    out[0] = s;
    out[1] = sqrtf(s);
    *done = 0u;   // ready for the next launch
  }
}

// one element: the plain version's expression, in its order
__device__ __forceinline__ void adam(float g, float& p, float& m, float& v, float scale,
                                     float lr, float b1t, float b2t, const Hyper& h) {
  g = g * scale;
  m = h.b1 * m + h.c1 * g;
  v = h.b2 * v + h.c2 * (g * g);
  const float mh = m / b1t;
  const float vh = v / b2t;
  p = p - lr * (mh / (sqrtf(vh) + h.eps) + h.wd * p);
}

template <typename P, typename G>
__device__ void chunk_update(const Leaf& f, long long lo, long long hi, float scale,
                             float lr, float b1t, float b2t, const Hyper& h) {
  const G* g = static_cast<const G*>(f.g);
  P* p = static_cast<P*>(f.p);
  long long tail = lo;
  if (f.vec) {
    const int nvec = static_cast<int>((hi - lo) / kVec);
    // two vectors a thread in flight (70 registers, 3 blocks an SM): 3 %
    // faster than one at DeepSeek's leaves; streaming cache hints were slower
#pragma unroll 2
    for (int k = threadIdx.x; k < nvec; k += kThreads) {
      const long long e = lo + static_cast<long long>(k) * kVec;
      float gx[kVec], px[kVec], mx[kVec], vx[kVec];
      load8(g + e, gx);
      load8(p + e, px);
      load8(f.m + e, mx);
      load8(f.v + e, vx);
#pragma unroll
      for (int j = 0; j < kVec; ++j) adam(gx[j], px[j], mx[j], vx[j], scale, lr, b1t, b2t, h);
      store8(p + e, px);
      store8(f.m + e, mx);
      store8(f.v + e, vx);
    }
    tail = lo + static_cast<long long>(nvec) * kVec;
  }
  for (long long e = tail + threadIdx.x; e < hi; e += kThreads) {
    float px = load1(p + e), mx = f.m[e], vx = f.v[e];
    adam(load1(g + e), px, mx, vx, scale, lr, b1t, b2t, h);
    store1(p + e, px);
    f.m[e] = mx;
    f.v[e] = vx;
  }
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Table t, const float* scale_p,
                    const float* lr_p, const float* b1t_p, const float* b2t_p, Hyper h) {
  const float scale = *scale_p, lr = *lr_p, b1t = *b1t_p, b2t = *b2t_p;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const Leaf& f = t.leaf[leaf_of(t, c)];
    const long long lo = static_cast<long long>(c - f.chunk0) * kChunk;
    const long long hi = min(f.n, lo + kChunk);
    switch (f.kind) {
      case 0: chunk_update<float, float>(f, lo, hi, scale, lr, b1t, b2t, h); break;
      case kGradBf16:
        chunk_update<float, __nv_bfloat16>(f, lo, hi, scale, lr, b1t, b2t, h); break;
      case kParamBf16:
        chunk_update<__nv_bfloat16, float>(f, lo, hi, scale, lr, b1t, b2t, h); break;
      default:
        chunk_update<__nv_bfloat16, __nv_bfloat16>(f, lo, hi, scale, lr, b1t, b2t, h);
    }
  }
}

bool aligned(const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; }

// the table of one launch, checked: every leaf has elements, its first chunk
// follows the leaf before's last, and the chunks add up
bool fill(Table& t, const void* const* g, void* const* p, float* const* m, float* const* v,
          const long long* n, const int* chunk0, const int* kind, int leaves, int chunks) {
  if (leaves < 1 || leaves > kMaxLeaves || chunks < 1) return false;
  long long next = 0;
  for (int i = 0; i < leaves; ++i) {
    if (n[i] < 1 || chunk0[i] != next || kind[i] < 0 || kind[i] > (kGradBf16 | kParamBf16) ||
        g[i] == nullptr)
      return false;
    next += (n[i] + kChunk - 1) / kChunk;
    Leaf& f = t.leaf[i];
    f.g = g[i];
    f.p = p ? p[i] : nullptr;
    f.m = m ? m[i] : nullptr;
    f.v = v ? v[i] : nullptr;
    f.n = n[i];
    f.chunk0 = chunk0[i];
    f.kind = kind[i];
    f.vec = aligned(f.g) && (!p || (aligned(f.p) && aligned(f.m) && aligned(f.v)));
  }
  if (next != chunks) return false;
  t.leaves = leaves;
  t.chunks = chunks;
  return true;
}

// a persistent grid: as many blocks as fit on the card at once, at most one
// a chunk
template <typename Kernel>
int grid_for(Kernel kernel, int chunks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  return chunks < blocks ? chunks : blocks;
}

}  // namespace

// The sum of squares of `leaves` gradient leaves (g: their pointers, n their
// elements, chunk0 each one's first chunk, kind kGradBf16 where bf16):
// out[0] = (accumulate ? out[0] : 0) + the sum, out[1] = sqrt(out[0]).
// `partials` holds `chunks` floats; `done` is 0 and left 0.
extern "C" int adamw_sumsq(const void* const* g, const long long* n, const int* chunk0,
                           const int* kind, int leaves, int chunks, float* partials,
                           unsigned* done, float* out, int accumulate, void* stream) {
  Table t;
  if (!fill(t, g, nullptr, nullptr, nullptr, n, chunk0, kind, leaves, chunks) ||
      partials == nullptr || done == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  adamw_sumsq_kernel<<<grid_for(adamw_sumsq_kernel, chunks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(t, partials, done, out, accumulate);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_launches[kSumsq];
  return static_cast<int>(e);
}

// One AdamW step of `leaves` leaves in place: params p (kind kParamBf16 where
// bf16, else fp32), fp32 moments m and v, grads g; the four scalars are fp32
// in device memory; b1, c1 = 1 - b1, b2, c2 = 1 - b2, eps and wd as the
// plain version rounds them to fp32.
extern "C" int adamw_update(const void* const* g, void* const* p, float* const* m,
                            float* const* v, const long long* n, const int* chunk0,
                            const int* kind, int leaves, int chunks, const float* scale,
                            const float* lr, const float* b1t, const float* b2t, float b1,
                            float c1, float b2, float c2, float eps, float wd, void* stream) {
  Table t;
  if (!fill(t, g, p, m, v, n, chunk0, kind, leaves, chunks) || scale == nullptr ||
      lr == nullptr || b1t == nullptr || b2t == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < leaves; ++i)
    if (t.leaf[i].p == nullptr || t.leaf[i].m == nullptr || t.leaf[i].v == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, c1, b2, c2, eps, wd};
  adamw_update_kernel<<<grid_for(adamw_update_kernel, chunks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(t, scale, lr, b1t, b2t, h);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_launches[kUpdate];
  return static_cast<int>(e);
}

extern "C" const char* adamw_kernel_name(int i) {
  return (i >= 0 && i < kNumKernels) ? kKernelNames[i] : nullptr;
}
extern "C" long long adamw_kernel_launches(int i) {
  return (i >= 0 && i < kNumKernels) ? g_launches[i] : -1;
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
