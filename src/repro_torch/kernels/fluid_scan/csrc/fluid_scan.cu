// The fluid surrogate's scan for NVIDIA Hopper (sm_90a), hand-written CUDA C++
// (K3).
//
// Replaces `_make_kernel` of src/repro/simcluster/surrogate.py: the JAX
// package's per-cell integration step, run as `lax.scan` over the steps inside
// a `lax.while_loop` (an early exit every 256 steps) under `jax.vmap` over the
// cells and `jax.jit`.  That is jnp, not Pallas, and XLA fuses it into one
// program; in eager PyTorch one step is some 400 tensor operations (the plain
// version, ../ref.py).  Here one launch runs the whole horizon of every cell
// of one (jobs, steps) bucket.
//
// What a cell is.  Per padded job: pending map and reduce mass, the finish
// time, local and remote launch mass, and four delay rings of 64 steps (map
// service, reduce service, successful parks, expired parks).  Per cell: the
// latch and the latched steps.  One step reads the maturing ring column,
// takes each ring's sum per job, allocates the free map slots in two rounds
// and the reduce slots in one (equal-share waterfilling, or strict priority
// in the cell's static order), scatters the launches into the rings at their
// quantised lags, and marks the jobs that finished.
//
// Two CUDA kernels, one a launch, which the wrapper picks from Jp alone
// (kernel.variant); both integrate each cell for the whole horizon and take
// every sum in the same fixed order, so both give the plain version's bits.
//
// fluid_scan_warp (Jp <= 128: the bench grid and every calibration bucket).
//  * One warp (one block of 32 threads) per cell; lane l owns jobs l + 32 k,
//    k < K = Jp / 32 (a template parameter: 1, 2, 4; below 32 jobs the lanes
//    past Jp hold padding).  A job's state lives in its owner's registers.
//  * Every sum over jobs is block_sum's tree without shared memory or a
//    barrier: an xor butterfly within each row of 32 jobs (register k is row
//    k), then the rows halved in registers; the values of one pass go
//    through the butterfly together.
//  * The priority allocator's Hillis-Steele scan runs in registers by
//    shuffles, its gather by priority and scatter back through the warp's
//    own slice of shared memory under __syncwarp; waterfilling rounds are
//    one shuffle pass each; the early exit is __any_sync.  No block barrier.
//  * The rings are rows of 64 floats (stride 68) a job in dynamic shared
//    memory, 4.3 KB a job: one cell an SM at 128 jobs, three at 64.  A lane
//    reads its own rows four floats at a time (no bank conflict), and a
//    ring's sum is ring_sum's tree with every halving unrolled (the block
//    variant's halving loop is not: its partial sums live in local memory).
//  * A ring whose last nonzero addition is 64 steps old holds +0 in every
//    slot; a row of jobs whose rings all are (padding jobs always) skips its
//    sum, which would be +0.  Every skip and shortcut gives the same bits.
//
// fluid_scan_block (Jp > 128, up to 2048; and at any Jp when named).
//  * One block (CTA) per cell; threads over the padded jobs, thread t owning
//    jobs t, t + blockDim, ...: one job a thread up to 256 jobs, eight a
//    thread above (K, a template parameter).  Only a job's owner touches its
//    ring entries, so the rings need no barrier at all.
//  * The rings are [64][Jp] fp32 each (column-major, so the threads of a warp
//    read consecutive words): in dynamic shared memory where the four fit
//    (Jp <= 128: 128 KB), else in a global scratch buffer the wrapper
//    allocates.
//  * Every sum over jobs is one fixed tree (rows of 32 jobs by a warp
//    butterfly, then the row sums halved), so a cell's result depends on
//    nothing but the cell, and equals the plain version's, which takes its
//    sums in the same order; a ring's sum over its 64 columns is the same
//    tree, in the owner's registers.  Several sums of one step share one
//    pass: two barriers each.
//  * The priority allocator's inclusive prefix sum is the Hillis-Steele scan
//    (the plain version's `_cumsum`) in shared memory; the order is static
//    per cell, computed on the host by a stable sort and passed in.
//
// Both: the equal-share waterfilling stops after the first round in which no
// job is unsatisfied (every later round adds 0; the plain version stops there
// too); the early exit is an "any real job unfinished" test every 256 steps;
// with diagnostics the whole horizon runs and one thread writes the 11
// per-step aggregates.  No fused multiply-add: the library is built with
// -fmad=false, so every product is rounded before the sum it feeds, as
// PyTorch's separate operations round it; round() is rintf (half to even, as
// jnp.round and torch.round), a float-to-int conversion truncates, exp and
// log1p are expf and log1pf.
//
// What bounds it on this card.  Each cell reads some 45 bytes a job and writes
// 20, so bytes bound nothing; the arithmetic of an integrated step is about
// 330 fp32 operations a padded job (the four ring sums are 252 of them), which
// at the fp32 peak is some 0.16 ms for the bench grid's 1000 cells of 128 jobs
// x 256 steps.  But a step depends on the step before it: each is a chain of
// dependent sums over the cell's jobs, so the kernel is bound by latency, far
// from either bound.  The block variant pays for its sums in shared-memory
// round trips through generic loads (its barriers cost 1.6 % of its time,
// scripts/fluid_scan_ablation.py); the warp variant keeps them in shuffles
// and registers, at one warp an SM at 128 jobs.
//
// The C interface at the end returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRing = 64;          // ring depth, steps (ref.RING)
constexpr int kChunk = 256;        // steps between early-exit tests (ref.CHUNK)
constexpr int kJobFields = 10;     // ref.JOB_FIELDS
constexpr int kScalarFields = 11;  // ref.SCALAR_FIELDS
constexpr int kDiag = 11;          // ref.DIAG_FIELDS
constexpr int kMaxThreads = 256;
constexpr int kWide = 8;           // jobs a thread above kMaxThreads jobs
constexpr int kMaxJobs = kMaxThreads * kWide;   // 2048 padded jobs
constexpr int kSmemRingJobs = 128; // rings in shared memory up to this bucket
constexpr int kMaxSums = 6;        // values one block_sum pass reduces
constexpr int kWarpMaxJobs = 128;  // the warp variant's largest bucket
constexpr int kRowStride = kRing + 4;  // floats a job's row of a ring, warp variant
constexpr unsigned kFull = 0xffffffffu;

// the launches of the kernel since the library was loaded, counted at the
// launch itself once it succeeded (read through fluid_kernel_launches)
enum FluidKernel { kFluidBlock, kFluidWarp, kNumKernels };
const char* const kKernelNames[kNumKernels] = {"fluid_scan_block", "fluid_scan_warp"};
// the variants, by the code the C function takes (kernel.VARIANT_CODES)
enum FluidVariant { kVariantBlock = 0, kVariantWarp = 1 };
long long g_launches[kNumKernels] = {};

// the model's constants, in the order of ref.FluidPhysics
struct Physics {
  float dt, park_success, park_wait, park_crowd_penalty, park_wait_crowd,
      repark_crowd, sat_lo, sat_width, locality_draws, delay_boost,
      delay_remote_wait, net_contention, eps, inf;
  int fair_iters;
};

struct Params {
  const float* jobs;     // [C, kJobFields, Jp]
  const int* order;      // [C, Jp]: the jobs in priority order
  const float* scalars;  // [C, kScalarFields]
  float* finish;         // [C, Jp]
  float* local;          // [C, Jp]
  float* remote;         // [C, Jp]
  float* map_rem;        // [C, Jp]
  float* red_rem;        // [C, Jp]
  float* latched;        // [C]
  int* steps;            // [C]: steps integrated
  float* diag;           // [C, n_steps, kDiag] or null
  float* rings;          // [C, 4, kRing, Jp] global scratch, or null (shared)
  int Jp, n_steps;
  Physics ph;
};

// What the block's sums need: rows of 32 jobs (or one row of Jp < 32).
struct Block {
  int lane, warp, nwarps, width, rows;
  float* red;   // [kMaxSums][rows]
  float* res;   // [kMaxSums]
};

// Sums over the cell's jobs of NV values, each job's values in its owner's
// vals[k][v]: a warp butterfly over each row of 32 jobs (lane i < off adds
// lane i + off, the halving order), the row sums to shared memory, then one
// warp a value halves the rows.  Every thread gets every sum.
template <int K, int NV>
__device__ __forceinline__ void block_sum(const Block& b, const float (&vals)[K][NV],
                                          float (&out)[NV]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float x = vals[k][v];
      for (int off = b.width >> 1; off > 0; off >>= 1)
        x = x + __shfl_xor_sync(0xffffffffu, x, off);
      if (b.lane == 0) b.red[v * b.rows + k * b.nwarps + b.warp] = x;
    }
  }
  __syncthreads();
  for (int v = b.warp; v < NV; v += b.nwarps) {
    float* r = b.red + v * b.rows;
    int m = b.rows;
    while (m > 32) {
      const int h = m >> 1;
      for (int i = b.lane; i < h; i += 32) r[i] = r[i] + r[i + h];
      __syncwarp();
      m = h;
    }
    float x = b.lane < m ? r[b.lane] : 0.f;
    for (int off = m >> 1; off > 0; off >>= 1)
      x = x + __shfl_xor_sync(0xffffffffu, x, off);
    if (b.lane == 0) b.res[v] = x;
  }
  __syncthreads();
#pragma unroll
  for (int v = 0; v < NV; ++v) out[v] = b.res[v];
}

// A ring's sum over its 64 columns for job j, in ref._tree_sum's order: each
// half of 32 halved (i + 16, then + 8, ...), then the two halves added.
__device__ __forceinline__ float ring_sum(const float* ring, int j, int Jp) {
  float half[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      s[i] = ring[(h * 32 + i) * Jp + j] + ring[(h * 32 + i + 16) * Jp + j];
#pragma unroll
    for (int w = 8; w >= 1; w >>= 1) {
#pragma unroll
      for (int i = 0; i < w; ++i) s[i] = s[i] + s[i + w];
    }
    half[h] = s[0];
  }
  return half[0] + half[1];
}

// Equal-share progressive filling of `capacity` over the jobs' `demand`
// (ref._fair_waterfill): each round splits the leftover equally among the
// unsatisfied jobs, and the loop stops at the first round without one.
template <int K>
__device__ __forceinline__ void fair_waterfill(const Block& b, const float (&demand)[K],
                                               float capacity, const Physics& ph,
                                               float (&alloc)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) alloc[k] = 0.f;
  for (int r = 0; r < ph.fair_iters; ++r) {
    float need[K], vals[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      need[k] = demand[k] - alloc[k];
      vals[k][0] = need[k] > ph.eps ? 1.f : 0.f;
      vals[k][1] = alloc[k];
    }
    float sums[2];
    block_sum<K, 2>(b, vals, sums);
    if (sums[0] == 0.f) break;           // the same for every thread
    const float n_unsat = fmaxf(sums[0], 1.f);
    const float leftover = fmaxf(capacity - sums[1], 0.f);
    const float share = leftover / n_unsat;
#pragma unroll
    for (int k = 0; k < K; ++k) alloc[k] = alloc[k] + fminf(need[k], share) * vals[k][0];
  }
}

// Strict-priority waterfilling (ref._priority_alloc): in priority order each
// job takes min(max(capacity - before, 0), d), where before is the inclusive
// prefix sum less its own demand d.  The thread owning job slot j also owns
// priority position j; `dbuf` holds the demands by job and then the
// allocations by job, `s0` / `s1` the scan.
template <int K>
__device__ __forceinline__ void priority_alloc(const Block& b, const float (&demand)[K],
                                               float capacity, const int (&ord)[K],
                                               int Jp, float* dbuf, float* s0, float* s1,
                                               float (&alloc)[K]) {
  const int tid = threadIdx.x, bd = blockDim.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * bd;
    if (j < Jp) dbuf[j] = demand[k];
  }
  __syncthreads();
  float d[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = tid + k * bd;
    d[k] = p < Jp ? dbuf[ord[k]] : 0.f;
    if (p < Jp) s0[p] = d[k];
  }
  __syncthreads();
  float* cur = s0;
  float* nxt = s1;
  for (int s = 1; s < Jp; s <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int p = tid + k * bd;
      if (p < Jp) nxt[p] = p >= s ? cur[p] + cur[p - s] : cur[p];
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = tid + k * bd;
    if (p < Jp) {
      const float before = cur[p] - d[k];
      dbuf[ord[k]] = fminf(fmaxf(capacity - before, 0.f), d[k]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * bd;
    alloc[k] = j < Jp ? dbuf[j] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void allocate(bool use_fair, const Block& b, const float (&demand)[K],
                                         float capacity, const Physics& ph, const int (&ord)[K],
                                         int Jp, float* dbuf, float* s0, float* s1,
                                         float (&alloc)[K]) {
  if (use_fair) fair_waterfill<K>(b, demand, capacity, ph, alloc);
  else priority_alloc<K>(b, demand, capacity, ord, Jp, dbuf, s0, s1, alloc);
}

__device__ __forceinline__ int wrap(int x) { return x & (kRing - 1); }   // x >= 0

template <int K>
__global__ void __launch_bounds__(kMaxThreads) fluid_scan_block(Params p) {
  extern __shared__ float smem[];
  const int cell = blockIdx.x, tid = threadIdx.x, bd = blockDim.x, Jp = p.Jp;
  const Physics& ph = p.ph;
  const float eps = ph.eps, inf = ph.inf, dt = ph.dt;

  // shared memory: the rings (where they fit), the sums' rows, the scan
  const bool smem_rings = p.rings == nullptr;
  float* rings = smem_rings ? smem : p.rings + static_cast<size_t>(cell) * 4 * kRing * Jp;
  float* work = smem_rings ? smem + 4 * kRing * Jp : smem;
  Block b;
  b.lane = tid & 31;
  b.warp = tid >> 5;
  b.nwarps = bd >> 5;
  b.width = Jp < 32 ? Jp : 32;
  b.rows = Jp < 32 ? 1 : Jp / 32;
  b.red = work;
  b.res = work + kMaxSums * b.rows;
  float* dbuf = b.res + kMaxSums;
  float* s0 = dbuf + Jp;
  float* s1 = s0 + Jp;
  float* ring_m = rings;
  float* ring_r = rings + kRing * Jp;
  float* park_s = rings + 2 * kRing * Jp;
  float* park_x = rings + 3 * kRing * Jp;

  const float* sc = p.scalars + static_cast<size_t>(cell) * kScalarFields;
  const float map_slots = sc[0], red_slots = sc[1], machines = sc[2];
  const float ordering = sc[4], park = sc[5], overload = sc[6];
  const float locality_delay = sc[7], max_wait = sc[8];
  const float pending_bar = sc[9], active_bar = sc[10];
  const bool use_fair_ordering = ordering >= 1.5f;
  const float ell_exponent = 1.f + ph.delay_boost * locality_delay;
  const int delay_lag = static_cast<int>(rintf(ph.delay_remote_wait * locality_delay / dt));
  const float crit_bar = 3.f * max_wait;

  // each owned job's inputs and state
  const float* jb = p.jobs + static_cast<size_t>(cell) * kJobFields * Jp;
  bool valid[K];
  int jj[K], ord[K], lag_ml[K], lag_mr[K], lag_rr[K];
  float submit[K], dl_abs[K], pad[K], lag_mr_f[K], lf_base[K];
  float pend_m[K], pend_r[K], finish[K], loc_acc[K], rem_acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * bd;
    valid[k] = j < Jp;
    jj[k] = valid[k] ? j : 0;
    const int q = jj[k];
    submit[k] = valid[k] ? jb[0 * Jp + q] : inf;
    dl_abs[k] = valid[k] ? jb[1 * Jp + q] : inf;
    pend_m[k] = valid[k] ? jb[2 * Jp + q] : 0.f;
    pend_r[k] = valid[k] ? jb[3 * Jp + q] : 0.f;
    lag_ml[k] = valid[k] ? static_cast<int>(jb[4 * Jp + q]) : 1;
    lag_mr_f[k] = valid[k] ? jb[5 * Jp + q] : 1.f;
    lag_mr[k] = static_cast<int>(lag_mr_f[k]);
    lag_rr[k] = valid[k] ? static_cast<int>(jb[6 * Jp + q]) : 1;
    const float log_miss = log1pf(-(valid[k] ? jb[7 * Jp + q] : 0.f));
    lf_base[k] = 1.f - expf(ell_exponent * ph.locality_draws * log_miss);
    pad[k] = valid[k] ? jb[9 * Jp + q] : 0.f;
    ord[k] = valid[k] ? p.order[static_cast<size_t>(cell) * Jp + q] : 0;
    finish[k] = inf;
    loc_acc[k] = 0.f;
    rem_acc[k] = 0.f;
    if (valid[k])
      for (int c = 0; c < 4 * kRing; ++c) rings[c * Jp + q] = 0.f;
  }
  bool latch = false;
  float lsteps = 0.f;
  int steps = 0;

  auto step = [&](int it) {
    const float t = static_cast<float>(it) * dt;
    const int idx = wrap(it);
    float sub[K], mat_s[K], mat_x[K], infl_m[K], infl_r[K], waiting[K];
    float map_open[K], red_open[K];
    {
      float vals[K][6];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int q = jj[k];
        sub[k] = (submit[k] <= t ? 1.f : 0.f) * pad[k];
        mat_s[k] = mat_x[k] = infl_m[k] = infl_r[k] = waiting[k] = 0.f;
        if (valid[k]) {
          // completions leave the ring first; maturing parks enter service
          ring_m[idx * Jp + q] = 0.f;
          ring_r[idx * Jp + q] = 0.f;
          mat_s[k] = park_s[idx * Jp + q];
          mat_x[k] = park_x[idx * Jp + q];
          park_s[idx * Jp + q] = 0.f;
          park_x[idx * Jp + q] = 0.f;
          infl_m[k] = ring_sum(ring_m, q, Jp);
          infl_r[k] = ring_sum(ring_r, q, Jp);
          waiting[k] = ring_sum(park_s, q, Jp) + ring_sum(park_x, q, Jp);
        }
        const float map_left = pend_m[k] + infl_m[k] + waiting[k] + mat_s[k] + mat_x[k];
        const float red_left = pend_r[k] + infl_r[k];
        map_open[k] = sub[k] * (map_left > eps ? 1.f : 0.f);
        red_open[k] = sub[k] * (map_left <= eps ? 1.f : 0.f) * (red_left > eps ? 1.f : 0.f);
        vals[k][0] = pend_m[k] * sub[k];
        vals[k][1] = sub[k] * ((map_left > eps) || (red_left > eps) ? 1.f : 0.f);
        vals[k][2] = infl_m[k];
        vals[k][3] = waiting[k];
        vals[k][4] = map_open[k];
        vals[k][5] = infl_r[k];
      }
      float sums[6];
      block_sum<K, 6>(b, vals, sums);
      const float pending = sums[0], active = sums[1];
      // latch entry and exit on beginning-of-step queue pressure
      const bool trip = (pending >= pending_bar) && (active >= active_bar);
      latch = (overload > 0.5f) && ((latch || trip) && (active > 0.5f));
      const bool use_fair = use_fair_ordering || latch;
      const bool park_on = (park > 0.5f) && !latch;
      const float chi_raw = active / machines;
      const float chi = fminf(fmaxf(chi_raw, 0.f), 1.f);
      // -- map demand: two allocation rounds
      const float sum_waiting = sums[3];
      const float free_m = fmaxf(map_slots - sums[2] - sum_waiting, 0.f);
      const float n_open = fmaxf(sums[4], 1.f);
      const float share = map_slots / n_open;
      float offered[K], launch1[K], launch2[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float cap = fmaxf(share - waiting[k], 0.f);
        offered[k] = fminf(pend_m[k], cap) * map_open[k];
      }
      allocate<K>(use_fair, b, offered, free_m, ph, ord, Jp, dbuf, s0, s1, launch1);
      float one[K][1], s1sum[1];
#pragma unroll
      for (int k = 0; k < K; ++k) one[k][0] = launch1[k];
      block_sum<K, 1>(b, one, s1sum);
      const float spare = fmaxf(free_m - s1sum[0], 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) offered[k] = fmaxf(pend_m[k] - launch1[k], 0.f) * map_open[k];
      allocate<K>(use_fair, b, offered, spare, ph, ord, Jp, dbuf, s0, s1, launch2);
      // -- park outcome odds and waits, degraded by the active crowd
      const float wait_eff = fminf(ph.park_wait * (1.f + ph.park_wait_crowd * chi), max_wait);
      const float p_succ = ph.park_success * fmaxf(1.f - ph.park_crowd_penalty * chi, 0.f);
      const int ws = static_cast<int>(rintf(wait_eff / dt));
      const float saturate = fminf(fmaxf((chi_raw - ph.sat_lo) / ph.sat_width, 0.f), 1.f);
      const int wx = min(static_cast<int>(rintf(max_wait * (1.f + ph.repark_crowd * saturate) / dt)),
                         kRing - 1);
      float launch[K], launch_loc[K], f_psucc[K], f_pexp[K], f_rem[K];
      float rem_vals[K][3];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        launch[k] = launch1[k] + launch2[k];
        launch_loc[k] = launch[k] * lf_base[k];
        const float rest = launch[k] - launch_loc[k];
        const bool crit = (dl_abs[k] - t) <= crit_bar;
        const float park_f = (park_on ? 1.f : 0.f) * (1.f - (crit ? 1.f : 0.f));
        f_psucc[k] = rest * park_f * p_succ;
        f_pexp[k] = rest * park_f * (1.f - p_succ);
        f_rem[k] = rest * (1.f - park_f);
        rem_vals[k][0] = f_rem[k] + mat_x[k];
        // the diagnostics' sums, taken in the same pass
        rem_vals[k][1] = launch[k];
        rem_vals[k][2] = (launch_loc[k] + f_psucc[k]) / fmaxf(launch[k], eps) * launch[k];
      }
      float rsums[3];
      if (p.diag) block_sum<K, 3>(b, rem_vals, rsums);
      else {
        float rv[K][1], rs[1];
#pragma unroll
        for (int k = 0; k < K; ++k) rv[k][0] = rem_vals[k][0];
        block_sum<K, 1>(b, rv, rs);
        rsums[0] = rs[0];
      }
      // remote reads launched together contend on the fabric
      const float rem_load = rsums[0] / map_slots;
      float off_r[K], launch_r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int lag_mr_eff = min(
            lag_mr[k] + delay_lag
                + static_cast<int>(rintf(lag_mr_f[k] * ph.net_contention * rem_load)),
            kRing - 1);
        if (valid[k]) {
          const int q = jj[k];
          ring_m[wrap(it + lag_ml[k]) * Jp + q] += launch_loc[k] + mat_s[k];
          ring_m[wrap(it + lag_mr_eff) * Jp + q] += f_rem[k] + mat_x[k];
          park_s[wrap(it + ws) * Jp + q] += f_psucc[k];
          park_x[wrap(it + wx) * Jp + q] += f_pexp[k];
        }
        const float pm = fmaxf(pend_m[k] - launch[k], 0.f);
        pend_m[k] = pm <= 0.01f ? 0.f : pm;
        loc_acc[k] = loc_acc[k] + launch_loc[k] + f_psucc[k];
        rem_acc[k] = rem_acc[k] + f_rem[k] + f_pexp[k];
        off_r[k] = pend_r[k] * red_open[k];
      }
      // -- reduce
      const float free_r = fmaxf(red_slots - sums[5], 0.f);
      allocate<K>(use_fair, b, off_r, free_r, ph, ord, Jp, dbuf, s0, s1, launch_r);
      float rl_vals[K][1];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (valid[k]) ring_r[wrap(it + lag_rr[k]) * Jp + jj[k]] += launch_r[k];
        const float pr = fmaxf(pend_r[k] - launch_r[k], 0.f);
        pend_r[k] = pr <= 0.01f ? 0.f : pr;
        // -- completions: the post-launch remaining mass
        const float map_left = pend_m[k] + infl_m[k] + launch_loc[k] + mat_s[k] + f_rem[k]
                               + mat_x[k] + waiting[k] + f_psucc[k] + f_pexp[k];
        const float red_left = pend_r[k] + infl_r[k] + launch_r[k];
        const bool done = (sub[k] > 0.5f) && (map_left <= eps) && (red_left <= eps);
        if (done && finish[k] >= inf) finish[k] = t + dt;
        rl_vals[k][0] = launch_r[k];
      }
      lsteps = lsteps + (latch ? 1.f : 0.f);
      if (p.diag) {
        float rl[1];
        block_sum<K, 1>(b, rl_vals, rl);
        if (tid == 0) {
          float* dg = p.diag + (static_cast<size_t>(cell) * p.n_steps + it) * kDiag;
          const float lsum = fmaxf(rsums[1], eps);
          dg[0] = active; dg[1] = pending; dg[2] = free_m; dg[3] = free_r;
          dg[4] = sum_waiting; dg[5] = sum_waiting; dg[6] = rsums[1]; dg[7] = rl[0];
          dg[8] = rsums[2] / lsum; dg[9] = chi; dg[10] = latch ? 1.f : 0.f;
        }
      }
    }
  };

  if (p.diag) {
    for (int it = 0; it < p.n_steps; ++it) step(it);
    steps = p.n_steps;
  } else {
    const int n_chunks = max(p.n_steps / kChunk, 1);
    for (int c = 0; c < n_chunks; ++c) {
      int unfinished = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) unfinished |= (finish[k] >= inf) && (pad[k] > 0.5f);
      if (!__syncthreads_or(unfinished)) break;
      for (int it = c * kChunk; it < (c + 1) * kChunk; ++it) step(it);
      steps += kChunk;
    }
  }

  const size_t base = static_cast<size_t>(cell) * Jp;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!valid[k]) continue;
    const size_t o = base + jj[k];
    p.finish[o] = finish[k];
    p.local[o] = loc_acc[k];
    p.remote[o] = rem_acc[k];
    p.map_rem[o] = pend_m[k];
    p.red_rem[o] = pend_r[k];
  }
  if (tid == 0) {
    p.latched[cell] = lsteps;
    p.steps[cell] = steps;
  }
}

// ---------------------------------------------------------------------------
// fluid_scan_warp: one warp a cell, up to kWarpMaxJobs padded jobs
// ---------------------------------------------------------------------------

// x[i] += x[i + W] for i < W: one level of a halving, unrolled (a loop whose
// step halves its bound is not, and its array then lives in local memory).
template <int W, int N>
__device__ __forceinline__ void halve(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = x[i] + x[i + W];
}

// Sums over the cell's jobs of NV values, lane l holding job l + 32 r's in
// vals[v][r] (register r is block_sum's row r): each row halved by an xor
// butterfly (offsets width / 2 down to 1; lane i < off adds lane i + off,
// the halving order, and lane i + off gets the same bits), lane 0's sums
// sent to every lane where the one row is narrower than the warp, then the
// rows halved in registers.  Every lane gets every sum, bit for bit
// block_sum's; the NV x K chains of a level are issued together.
template <int K, int NV>
__device__ __forceinline__ void warp_sum(int width, const float (&vals)[NV][K],
                                         float (&out)[NV]) {
  float x[NV][K];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int r = 0; r < K; ++r) x[v][r] = vals[v][r];
  const int w = K > 1 ? 32 : width;
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int off = 16 >> level;
    if (off >= w) continue;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int r = 0; r < K; ++r) x[v][r] = x[v][r] + __shfl_xor_sync(kFull, x[v][r], off);
  }
  if (w < 32) {
#pragma unroll
    for (int v = 0; v < NV; ++v) x[v][0] = __shfl_sync(kFull, x[v][0], 0);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if constexpr (K == 4) halve<2>(x[v]);
    if constexpr (K >= 2) halve<1>(x[v]);
    out[v] = x[v][0];
  }
}

// A ring's sum over its 64 slots for one job, whose row of the ring is
// 16-byte aligned: ring_sum's tree, read as 16 four-float loads.
__device__ __forceinline__ float warp_ring_sum(const float* row) {
  float c[kRing];
#pragma unroll
  for (int i = 0; i < kRing / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(row)[i];
    c[4 * i] = q.x; c[4 * i + 1] = q.y; c[4 * i + 2] = q.z; c[4 * i + 3] = q.w;
  }
  float half[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = c[h * 32 + i] + c[h * 32 + i + 16];
    halve<8>(s);
    halve<4>(s);
    halve<2>(s);
    halve<1>(s);
    half[h] = s[0];
  }
  return half[0] + half[1];
}

// warp_ring_sum of the rings of a row of jobs (one per lane) where some
// lane's ring may hold a nonzero slot, else +0 without reading them.  A
// value added at step s lands in the slot that step s + lag clears, at most
// kRing steps later, and slots are never -0 (they start +0, are cleared to
// +0, and a sum is -0 only of two -0), so a ring whose last nonzero addition
// (`last`) is kRing or more steps old holds +0 in every slot and its tree
// sum is +0: the same bits.  The test is warp-uniform.
__device__ __forceinline__ float warp_live_ring_sum(int it, int last, const float* row) {
  if (!__any_sync(kFull, it - last < kRing)) return 0.f;
  return warp_ring_sum(row);
}

// fair_waterfill on the warp: one interleaved pass of two sums a round.
template <int K>
__device__ __forceinline__ void warp_fair_waterfill(int width, const float (&demand)[K],
                                                    float capacity, const Physics& ph,
                                                    float (&alloc)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) alloc[k] = 0.f;
  for (int r = 0; r < ph.fair_iters; ++r) {
    float need[K], vals[2][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      need[k] = demand[k] - alloc[k];
      vals[0][k] = need[k] > ph.eps ? 1.f : 0.f;
      vals[1][k] = alloc[k];
    }
    float sums[2];
    warp_sum<K, 2>(width, vals, sums);
    if (sums[0] == 0.f) break;           // the same on every lane
    const float n_unsat = fmaxf(sums[0], 1.f);
    const float leftover = fmaxf(capacity - sums[1], 0.f);
    const float share = leftover / n_unsat;
#pragma unroll
    for (int k = 0; k < K; ++k) alloc[k] = alloc[k] + fminf(need[k], share) * vals[0][k];
  }
}

// priority_alloc on the warp.  Lane l owns job slots and priority positions
// l + 32 r.  The demands go by job into the warp's `dbuf`, come back in
// priority order, and the inclusive prefix sum is the Hillis-Steele scan in
// registers: position p = l + 32 r adds position p - s, for s < 32 a
// shuffle from lane (l - s) mod 32 of row r, or of row r - 1 for lanes
// below s, for s >= 32 row r - s / 32 of its own.  The allocations go back
// by job through `dbuf`.  Only __syncwarp orders the accesses.
template <int K>
__device__ __forceinline__ void warp_priority_alloc(int lane, int Jp, const float (&demand)[K],
                                                    float capacity, const int (&ord)[K],
                                                    float* dbuf, float (&alloc)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    if (j < Jp) dbuf[j] = demand[k];
  }
  __syncwarp();
  float d[K], cur[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    d[k] = lane + 32 * k < Jp ? dbuf[ord[k]] : 0.f;
    cur[k] = d[k];
  }
  __syncwarp();
  for (int s = 1; s < Jp; s <<= 1) {
    if (s < 32) {
      const int src = (lane - s) & 31;
      float sh[K];
#pragma unroll
      for (int k = 0; k < K; ++k) sh[k] = __shfl_sync(kFull, cur[k], src);
      const bool same_row = lane >= s;
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        if (same_row) cur[k] = cur[k] + sh[k];
        else if (k > 0) cur[k] = cur[k] + sh[k > 0 ? k - 1 : 0];
      }
    } else {
      // s is 32 or 64 (K <= 4): rows from the top down read rows not yet moved
      const int rs = s >> 5;
#pragma unroll
      for (int k = K - 1; k >= 1; --k) {
        if (rs == 1) cur[k] = cur[k] + cur[k - 1];
        else if (k >= 2) cur[k] = cur[k] + cur[k >= 2 ? k - 2 : 0];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + 32 * k < Jp) {
      const float before = cur[k] - d[k];
      dbuf[ord[k]] = fminf(fmaxf(capacity - before, 0.f), d[k]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    alloc[k] = j < Jp ? dbuf[j] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void warp_allocate(bool use_fair, int lane, int width, int Jp,
                                              const float (&demand)[K], float capacity,
                                              const Physics& ph, const int (&ord)[K],
                                              float* dbuf, float (&alloc)[K]) {
  if (use_fair) warp_fair_waterfill<K>(width, demand, capacity, ph, alloc);
  else warp_priority_alloc<K>(lane, Jp, demand, capacity, ord, dbuf, alloc);
}

// fluid_scan_warp: the cells of one bucket of Jp <= kWarpMaxJobs jobs, one
// warp (one block) a cell for the whole horizon; lane l owns jobs l + 32 k,
// k < K (K = Jp / 32, or 1 with lanes past Jp holding padding that no sum
// of a real lane reads).  The step is fluid_scan_block's, expression for
// expression, with its sums on warp_sum, its allocators on the warp, and
// each job's rings as rows of kRowStride floats in shared memory:
// [ring][job][kRowStride], so lanes reading four floats each of their own
// rows hit distinct banks.  No block barrier anywhere.
template <int K>
__global__ void __launch_bounds__(32) fluid_scan_warp(Params p) {
  extern __shared__ __align__(16) float wsmem[];
  const int cell = blockIdx.x, lane = threadIdx.x, Jp = p.Jp;
  const int width = Jp < 32 ? Jp : 32;
  const Physics ph = p.ph;   // a copy: a reference into the parameters spills them
  const float eps = ph.eps, inf = ph.inf, dt = ph.dt;
  const int ring_floats = Jp * kRowStride;
  float* ring_m = wsmem;
  float* ring_r = wsmem + ring_floats;
  float* park_s = wsmem + 2 * ring_floats;
  float* park_x = wsmem + 3 * ring_floats;
  float* dbuf = wsmem + 4 * ring_floats;

  const float* sc = p.scalars + static_cast<size_t>(cell) * kScalarFields;
  const float map_slots = sc[0], red_slots = sc[1], machines = sc[2];
  const float ordering = sc[4], park = sc[5], overload = sc[6];
  const float locality_delay = sc[7], max_wait = sc[8];
  const float pending_bar = sc[9], active_bar = sc[10];
  const bool use_fair_ordering = ordering >= 1.5f;
  const float ell_exponent = 1.f + ph.delay_boost * locality_delay;
  const int delay_lag = static_cast<int>(rintf(ph.delay_remote_wait * locality_delay / dt));
  const float crit_bar = 3.f * max_wait;

  // each owned job's inputs and state; row[k] is its rings' row offset
  const float* jb = p.jobs + static_cast<size_t>(cell) * kJobFields * Jp;
  bool valid[K];
  int row[K], ord[K], lag_ml[K], lag_mr[K], lag_rr[K];
  float submit[K], dl_abs[K], pad[K], lag_mr_f[K], lf_base[K];
  float pend_m[K], pend_r[K], finish[K], loc_acc[K], rem_acc[K];
  // the last step that added a nonzero value to each ring of a job
  int live_m[K], live_r[K], live_s[K], live_x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    live_m[k] = live_r[k] = live_s[k] = live_x[k] = -kRing;
    valid[k] = K > 1 || j < Jp;   // Jp = 32 K above one row
    const int q = valid[k] ? j : 0;
    row[k] = q * kRowStride;
    submit[k] = valid[k] ? jb[0 * Jp + q] : inf;
    dl_abs[k] = valid[k] ? jb[1 * Jp + q] : inf;
    pend_m[k] = valid[k] ? jb[2 * Jp + q] : 0.f;
    pend_r[k] = valid[k] ? jb[3 * Jp + q] : 0.f;
    lag_ml[k] = valid[k] ? static_cast<int>(jb[4 * Jp + q]) : 1;
    lag_mr_f[k] = valid[k] ? jb[5 * Jp + q] : 1.f;
    lag_mr[k] = static_cast<int>(lag_mr_f[k]);
    lag_rr[k] = valid[k] ? static_cast<int>(jb[6 * Jp + q]) : 1;
    const float log_miss = log1pf(-(valid[k] ? jb[7 * Jp + q] : 0.f));
    lf_base[k] = 1.f - expf(ell_exponent * ph.locality_draws * log_miss);
    pad[k] = valid[k] ? jb[9 * Jp + q] : 0.f;
    ord[k] = valid[k] ? p.order[static_cast<size_t>(cell) * Jp + q] : 0;
    finish[k] = inf;
    loc_acc[k] = 0.f;
    rem_acc[k] = 0.f;
    if (valid[k]) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float4* r4 = reinterpret_cast<float4*>(wsmem + g * ring_floats + row[k]);
#pragma unroll
        for (int i = 0; i < kRing / 4; ++i) r4[i] = zero;
      }
    }
  }
  bool latch = false;
  float lsteps = 0.f;
  int steps = 0;

  auto step = [&](int it) {
    const float t = static_cast<float>(it) * dt;
    const int idx = wrap(it);
    float sub[K], mat_s[K], mat_x[K], infl_m[K], infl_r[K], waiting[K];
    float map_open[K], red_open[K];
    float vals[6][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int o = row[k];
      sub[k] = (submit[k] <= t ? 1.f : 0.f) * pad[k];
      mat_s[k] = mat_x[k] = infl_m[k] = infl_r[k] = waiting[k] = 0.f;
      if (valid[k]) {
        // completions leave the ring first; maturing parks enter service
        ring_m[o + idx] = 0.f;
        ring_r[o + idx] = 0.f;
        mat_s[k] = park_s[o + idx];
        mat_x[k] = park_x[o + idx];
        park_s[o + idx] = 0.f;
        park_x[o + idx] = 0.f;
      }
      // every lane takes part (a padding lane reads job 0's rows and drops them)
      const float sm = warp_live_ring_sum(it, live_m[k], ring_m + o);
      const float sr = warp_live_ring_sum(it, live_r[k], ring_r + o);
      const float ss = warp_live_ring_sum(it, live_s[k], park_s + o);
      const float sx = warp_live_ring_sum(it, live_x[k], park_x + o);
      if (valid[k]) {
        infl_m[k] = sm;
        infl_r[k] = sr;
        waiting[k] = ss + sx;
      }
      const float map_left = pend_m[k] + infl_m[k] + waiting[k] + mat_s[k] + mat_x[k];
      const float red_left = pend_r[k] + infl_r[k];
      map_open[k] = sub[k] * (map_left > eps ? 1.f : 0.f);
      red_open[k] = sub[k] * (map_left <= eps ? 1.f : 0.f) * (red_left > eps ? 1.f : 0.f);
      vals[0][k] = pend_m[k] * sub[k];
      vals[1][k] = sub[k] * ((map_left > eps) || (red_left > eps) ? 1.f : 0.f);
      vals[2][k] = infl_m[k];
      vals[3][k] = waiting[k];
      vals[4][k] = map_open[k];
      vals[5][k] = infl_r[k];
    }
    float sums[6];
    warp_sum<K, 6>(width, vals, sums);
    const float pending = sums[0], active = sums[1];
    // latch entry and exit on beginning-of-step queue pressure
    const bool trip = (pending >= pending_bar) && (active >= active_bar);
    latch = (overload > 0.5f) && ((latch || trip) && (active > 0.5f));
    const bool use_fair = use_fair_ordering || latch;
    const bool park_on = (park > 0.5f) && !latch;
    const float chi_raw = active / machines;
    const float chi = fminf(fmaxf(chi_raw, 0.f), 1.f);
    // -- map demand: two allocation rounds
    const float sum_waiting = sums[3];
    const float free_m = fmaxf(map_slots - sums[2] - sum_waiting, 0.f);
    const float n_open = fmaxf(sums[4], 1.f);
    const float share = map_slots / n_open;
    float offered[K], launch1[K], launch2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float cap = fmaxf(share - waiting[k], 0.f);
      offered[k] = fminf(pend_m[k], cap) * map_open[k];
    }
    warp_allocate<K>(use_fair, lane, width, Jp, offered, free_m, ph, ord, dbuf, launch1);
    float one[1][K], s1sum[1];
#pragma unroll
    for (int k = 0; k < K; ++k) one[0][k] = launch1[k];
    warp_sum<K, 1>(width, one, s1sum);
    const float spare = fmaxf(free_m - s1sum[0], 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) offered[k] = fmaxf(pend_m[k] - launch1[k], 0.f) * map_open[k];
    warp_allocate<K>(use_fair, lane, width, Jp, offered, spare, ph, ord, dbuf, launch2);
    // -- park outcome odds and waits, degraded by the active crowd
    const float wait_eff = fminf(ph.park_wait * (1.f + ph.park_wait_crowd * chi), max_wait);
    const float p_succ = ph.park_success * fmaxf(1.f - ph.park_crowd_penalty * chi, 0.f);
    const int ws = static_cast<int>(rintf(wait_eff / dt));
    const float saturate = fminf(fmaxf((chi_raw - ph.sat_lo) / ph.sat_width, 0.f), 1.f);
    const int wx = min(static_cast<int>(rintf(max_wait * (1.f + ph.repark_crowd * saturate) / dt)),
                       kRing - 1);
    float launch[K], launch_loc[K], f_psucc[K], f_pexp[K], f_rem[K];
    float rem_vals[3][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      launch[k] = launch1[k] + launch2[k];
      launch_loc[k] = launch[k] * lf_base[k];
      const float rest = launch[k] - launch_loc[k];
      const bool crit = (dl_abs[k] - t) <= crit_bar;
      const float park_f = (park_on ? 1.f : 0.f) * (1.f - (crit ? 1.f : 0.f));
      f_psucc[k] = rest * park_f * p_succ;
      f_pexp[k] = rest * park_f * (1.f - p_succ);
      f_rem[k] = rest * (1.f - park_f);
      rem_vals[0][k] = f_rem[k] + mat_x[k];
      // the diagnostics' sums, taken in the same pass (a division a job: only
      // where they are asked for)
      if (p.diag) {
        rem_vals[1][k] = launch[k];
        rem_vals[2][k] = (launch_loc[k] + f_psucc[k]) / fmaxf(launch[k], eps) * launch[k];
      }
    }
    float rsums[3];
    if (p.diag) warp_sum<K, 3>(width, rem_vals, rsums);
    else {
      float rv[1][K], rs[1];
#pragma unroll
      for (int k = 0; k < K; ++k) rv[0][k] = rem_vals[0][k];
      warp_sum<K, 1>(width, rv, rs);
      rsums[0] = rs[0];
    }
    // remote reads launched together contend on the fabric
    const float rem_load = rsums[0] / map_slots;
    float off_r[K], launch_r[K];
    // the launches into the rings, as fluid_scan_block adds them: every slot
    // read first, then written, so that the adds do not wait on one another
    // (where both map launches land in one slot, the second adds to the first)
    int sm1[K], sm2[K];
    float xm1[K], xm2[K], xs[K], xx[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int lag_mr_eff = min(
          lag_mr[k] + delay_lag
              + static_cast<int>(rintf(lag_mr_f[k] * ph.net_contention * rem_load)),
          kRing - 1);
      const int o = row[k];
      sm1[k] = o + wrap(it + lag_ml[k]);
      sm2[k] = o + wrap(it + lag_mr_eff);
      if (valid[k]) {
        xm1[k] = ring_m[sm1[k]];
        xm2[k] = ring_m[sm2[k]];
        xs[k] = park_s[o + wrap(it + ws)];
        xx[k] = park_x[o + wrap(it + wx)];
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (valid[k]) {
        const int o = row[k];
        const float m1 = xm1[k] + (launch_loc[k] + mat_s[k]);
        const float m2 = (sm1[k] == sm2[k] ? m1 : xm2[k]) + (f_rem[k] + mat_x[k]);
        ring_m[sm1[k]] = m1;
        ring_m[sm2[k]] = m2;
        park_s[o + wrap(it + ws)] = xs[k] + f_psucc[k];
        park_x[o + wrap(it + wx)] = xx[k] + f_pexp[k];
      }
      if (launch_loc[k] + mat_s[k] != 0.f || f_rem[k] + mat_x[k] != 0.f) live_m[k] = it;
      if (f_psucc[k] != 0.f) live_s[k] = it;
      if (f_pexp[k] != 0.f) live_x[k] = it;
      const float pm = fmaxf(pend_m[k] - launch[k], 0.f);
      pend_m[k] = pm <= 0.01f ? 0.f : pm;
      loc_acc[k] = loc_acc[k] + launch_loc[k] + f_psucc[k];
      rem_acc[k] = rem_acc[k] + f_rem[k] + f_pexp[k];
      off_r[k] = pend_r[k] * red_open[k];
    }
    // -- reduce
    const float free_r = fmaxf(red_slots - sums[5], 0.f);
    warp_allocate<K>(use_fair, lane, width, Jp, off_r, free_r, ph, ord, dbuf, launch_r);
    float rl_vals[1][K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (valid[k]) ring_r[row[k] + wrap(it + lag_rr[k])] += launch_r[k];
      if (launch_r[k] != 0.f) live_r[k] = it;
      const float pr = fmaxf(pend_r[k] - launch_r[k], 0.f);
      pend_r[k] = pr <= 0.01f ? 0.f : pr;
      // -- completions: the post-launch remaining mass
      const float map_left = pend_m[k] + infl_m[k] + launch_loc[k] + mat_s[k] + f_rem[k]
                             + mat_x[k] + waiting[k] + f_psucc[k] + f_pexp[k];
      const float red_left = pend_r[k] + infl_r[k] + launch_r[k];
      const bool done = (sub[k] > 0.5f) && (map_left <= eps) && (red_left <= eps);
      if (done && finish[k] >= inf) finish[k] = t + dt;
      rl_vals[0][k] = launch_r[k];
    }
    lsteps = lsteps + (latch ? 1.f : 0.f);
    if (p.diag) {
      float rl[1];
      warp_sum<K, 1>(width, rl_vals, rl);
      if (lane == 0) {
        float* dg = p.diag + (static_cast<size_t>(cell) * p.n_steps + it) * kDiag;
        const float lsum = fmaxf(rsums[1], eps);
        dg[0] = active; dg[1] = pending; dg[2] = free_m; dg[3] = free_r;
        dg[4] = sum_waiting; dg[5] = sum_waiting; dg[6] = rsums[1]; dg[7] = rl[0];
        dg[8] = rsums[2] / lsum; dg[9] = chi; dg[10] = latch ? 1.f : 0.f;
      }
    }
  };

  if (p.diag) {
    for (int it = 0; it < p.n_steps; ++it) step(it);
    steps = p.n_steps;
  } else {
    const int n_chunks = max(p.n_steps / kChunk, 1);
    for (int c = 0; c < n_chunks; ++c) {
      int unfinished = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) unfinished |= (finish[k] >= inf) && (pad[k] > 0.5f);
      if (!__any_sync(kFull, unfinished)) break;
      for (int it = c * kChunk; it < (c + 1) * kChunk; ++it) step(it);
      steps += kChunk;
    }
  }

  const size_t base = static_cast<size_t>(cell) * Jp;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!valid[k]) continue;
    const size_t o = base + lane + 32 * k;
    p.finish[o] = finish[k];
    p.local[o] = loc_acc[k];
    p.remote[o] = rem_acc[k];
    p.map_rem[o] = pend_m[k];
    p.red_rem[o] = pend_r[k];
  }
  if (lane == 0) {
    p.latched[cell] = lsteps;
    p.steps[cell] = steps;
  }
}

size_t smem_bytes(int Jp, bool smem_rings) {
  const int rows = Jp < 32 ? 1 : Jp / 32;
  const size_t work = (kMaxSums * rows + kMaxSums + 3 * Jp) * sizeof(float);
  return work + (smem_rings ? 4 * kRing * Jp * sizeof(float) : 0);
}

template <int K>
cudaError_t launch(const Params& p, int cells, int threads, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory has to be asked for, once for
  // each instance, for the largest bucket it takes
  static const cudaError_t attr = cudaFuncSetAttribute(
      fluid_scan_block<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(K == 1 ? smem_bytes(kSmemRingJobs, true)
                              : smem_bytes(kMaxJobs, false)));
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_bytes(p.Jp, p.rings == nullptr);
  fluid_scan_block<K><<<cells, threads, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_launches[kFluidBlock];
  return e;
}

// the warp variant's shared memory: four rings of Jp rows, then dbuf
size_t warp_smem_bytes(int Jp) { return (4 * Jp * kRowStride + Jp) * sizeof(float); }

template <int K>
cudaError_t launch_warp(const Params& p, int cells, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      fluid_scan_warp<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(warp_smem_bytes(32 * K)));
  if (attr != cudaSuccess) return attr;
  fluid_scan_warp<K><<<cells, 32, warp_smem_bytes(p.Jp), stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++g_launches[kFluidWarp];
  return e;
}

}  // namespace

// Integrate `cells` cells of one (Jp jobs, n_steps steps) bucket by the
// variant `variant` names (FluidVariant): Jp a power of two from 8 to 2048
// (the warp variant: to kWarpMaxJobs); `rings` a scratch of cells * 4 * 64 *
// Jp floats where Jp > 128 (null otherwise); `diag` null or [cells, n_steps,
// 11]; `physics` a host array of the 14 floats of ref.FluidPhysics.  A
// variant that does not take the bucket is refused, never replaced.
extern "C" int fluid_scan(const float* jobs, const int* order, const float* scalars,
                          const float* physics, int fair_iters, float* finish, float* local,
                          float* remote, float* map_rem, float* red_rem, float* latched,
                          int* steps, float* diag, float* rings, int cells, int Jp,
                          int n_steps, int variant, void* stream) {
  if (Jp < 8 || Jp > kMaxJobs || (Jp & (Jp - 1)) || cells < 1 || n_steps < 1 ||
      fair_iters < 0 || (variant != kVariantBlock && variant != kVariantWarp) ||
      (variant == kVariantWarp && Jp > kWarpMaxJobs) ||
      (Jp > kSmemRingJobs) != (rings != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.jobs = jobs; p.order = order; p.scalars = scalars;
  p.finish = finish; p.local = local; p.remote = remote;
  p.map_rem = map_rem; p.red_rem = red_rem; p.latched = latched; p.steps = steps;
  p.diag = diag; p.rings = rings; p.Jp = Jp; p.n_steps = n_steps;
  Physics& ph = p.ph;
  ph.dt = physics[0]; ph.park_success = physics[1]; ph.park_wait = physics[2];
  ph.park_crowd_penalty = physics[3]; ph.park_wait_crowd = physics[4];
  ph.repark_crowd = physics[5]; ph.sat_lo = physics[6]; ph.sat_width = physics[7];
  ph.locality_draws = physics[8]; ph.delay_boost = physics[9];
  ph.delay_remote_wait = physics[10]; ph.net_contention = physics[11];
  ph.eps = physics[12]; ph.inf = physics[13]; ph.fair_iters = fair_iters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kVariantWarp)   // a warp a cell, Jp / 32 jobs a lane (one below 32)
    return static_cast<int>(Jp <= 32   ? launch_warp<1>(p, cells, s)
                            : Jp == 64 ? launch_warp<2>(p, cells, s)
                                       : launch_warp<4>(p, cells, s));
  // a thread a job up to kMaxThreads jobs, else kWide jobs a thread
  const cudaError_t e =
      Jp <= kMaxThreads ? launch<1>(p, cells, Jp < 32 ? 32 : Jp, s)
                        : launch<kWide>(p, cells, Jp / kWide, s);
  return static_cast<int>(e);
}

extern "C" const char* fluid_kernel_name(int i) {
  return (i >= 0 && i < kNumKernels) ? kKernelNames[i] : nullptr;
}
extern "C" long long fluid_kernel_launches(int i) {
  return (i >= 0 && i < kNumKernels) ? g_launches[i] : -1;
}

extern "C" const char* fluid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
