// Speed-of-light probe of the compositing kernels, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU probes named sol_kernel:
//   scripts/_r4_session.py:321 (call :377) — k_ops multiply-adds per element;
//   scripts/_r5_session.py:327 (call :397) — the same plus k_exp exps. Its
//   use_while switch (fori_loop against while_loop) has no counterpart: a
//   CUDA loop is one loop, so its w20e0 configuration is (20, 0) here.
//
// What it computes, for each tile t (the probes' semantics exactly):
//   start, end = tile_start[t], tile_start[t + 1]; win = (start / 128) * 128
//   nch = ceil((end - win) / 128)   -- 1, not 0, for an empty tile whose
//                                      start is not a multiple of 128
//   x[p][l] = 0 for the 256 pixels p and 128 lanes l
//   for ci < nch:
//     x[p][l] += table[win / 128 + ci][0][l]        (row 0 of the chunk; the
//                                                     absolute chunk index
//                                                     reads other tiles' pairs)
//     k_ops times: x = x * f32(1.0000001) + f32(0.3 + j * 1e-7)
//     k_exp times: x = expf(a * x - b[j])
//   out[t][p] = the sum of x[p][l] over l
// The probes' exp coefficients are a = f32(-1e-6), b[j] = f32(0.1 + j * 1e-7):
// the double values rounded to float32, as JAX rounds a Python float against
// a float32 array; each j has its own constant, so no step of a chain folds
// into another. Under them x settles to exp's fixed point after one pass,
// whatever went in, so a wrong pass count or chunk changes the output by
// less than 1e-6 relative. Hence each exp pair has a second instance
// (PROBE = false) that takes a and b from a kernel parameter (ExpCoef), run
// with coefficients under which the output depends on every pass and every
// chunk (ops/cuda_probe.py:check_exp_coefs). The instance the probes time
// (PROBE = true) has a as an immediate, as the TPU probe's trace-time
// constant, and b in constant memory: read from the parameter, the same
// coefficients made an exp pass 8% slower (CHANGES.md).
//
// Every (pixel, lane, chunk) element does its full work: the row add, the
// k_ops multiply-add chain and the k_exp exps, expf, not __expf, and no
// fast math. The result does not depend on the pixel, but computing a
// tile's chains once would do 1/256 of the work the bound counts.
//
// Occupancy. WARPS = 8, 24 or 48 resident warps per SM: 8 is the
// one-block-per-SM design of the first port, 24 composite_bwd.cu's (3
// blocks per SM) and 48 the forward kernels' (composite_blend.cuh, 6).
// Blocks are 256 threads (8 warps) at every occupancy, as in the
// compositing kernels. The carry x is 128 floats a pixel; at 24 and 48
// warps a thread has only 80 and 40 registers, so SPLIT = 2 or 8 threads
// share a pixel, each carrying LPT = 64 or 16 of its lanes (32 lanes at 40
// registers spilled, even at k_ops = 4), and a tile is SPLIT
// blocks of 256 / SPLIT pixels each (block b holds part b % SPLIT of tile
// b / SPLIT, so a tile's parts are neighbours in the launch order). Each
// block pays its start (tile_start, then the first row) once, so the
// skeleton's floor grows with SPLIT (PERF.md).
// Splitting the tile over blocks, not over a block's passes, keeps every
// thread's carry in registers across the chunks. A thread's lanes are
// 4 (sub + SPLIT q) .. + 3 for q < LPT / 4, so the SPLIT threads of a pixel
// read neighbouring 16-byte words of the staged row (no bank conflict). The
// pixel's sum: each thread adds its lanes in order, then a butterfly of
// warp shuffles over the SPLIT threads (lanes sub of one pixel are
// neighbours in the warp). That is another order of the 128-lane sum than
// the plain version's; float32 reassociation of 128 values near 1 stays
// inside the card tolerance PROBE_RTOL = 2e-5 (chip_smoke.py). The
// occupancy is pinned, not left to the register count: each launch asks for
// enough dynamic shared memory that exactly WARPS / 8 blocks fit on an SM,
// and the first launch of an instance refuses to run if
// cudaOccupancyMaxActiveBlocksPerMultiprocessor says otherwise.
// __launch_bounds__(256, WARPS / 8) caps ptxas at 255, 80 and 40
// registers; gsjax_sol_probe_info reports each instance's registers,
// local memory (spills) and resident blocks.
//
// Staging. Row 0 of each chunk (512 bytes) is copied into a ring of
// NBUF = 4 shared-memory buffers by cp.async, AHEAD = 3 chunks ahead of the
// math: warp 0's 32 threads copy 16 bytes each and commit one group a chunk
// (an empty group past the window, so the counts stay uniform). At chunk
// ci warp 0 waits until at most AHEAD - 1 of its groups are in flight
// (chunk ci has landed) and one barrier publishes it; after the barrier
// every thread is done with chunk ci - 1, whose buffer then takes chunk
// ci + AHEAD. So a chunk's load overlaps the math of the three before it,
// the counterpart of the TPU probe's double-buffered DMA, with one barrier
// a chunk (the first port had two, around a plain load). Each of a tile's
// SPLIT blocks stages the rows itself: the copies hit L2, and at k_ops = 4
// and 16 lanes a thread a 512-byte row still feeds 36,864 operations.
//
// Chains. The multiply-add chains are unrolled at compile time as the TPU
// probe unrolled them at trace time: one instance per swept (k_ops, k_exp)
// pair and occupancy (and the checking one of an exp pair), and any other
// is refused. A thread updates GROUP = min(LPT, 64) independent chains
// together, which gives each pass that much instruction-level parallelism
// (at 8 warps, one warp per scheduler pair, it is the only cover of the
// arithmetic latency). The exp passes run as a loop unrolled by 2 at 8
// warps and not unrolled at 24 and 48 (EXP_UNROLL): fully unrolled, ptxas
// scheduled them with only a few exps in flight and the pass measured that
// schedule's latency instead of expf's rate (CHANGES.md).
//
// Bound (utils/profiling.py: sol_probe_work, bound_ms): sum_t nch_t * 256 *
// 128 elements, each 1 + 2 k_ops + 3 k_exp float32 operations (an exp
// counted as one) at the H100 SXM data sheet's 67 TFLOP/s; k_exp exps an
// element at the special-function units' rate (16 a clock an SM, the CUDA
// programming guide's throughput table for compute capability 9.0: 4.18e12
// exp/s at 1.98 GHz), and sum_t nch_t * 512 bytes of rows plus tile_start
// and the output at 3.35 TB/s; the largest of the three. An accurate expf
// is about nine instructions with one MUFU.EX2, so an exp pass costs FMA
// issue slots as well as the MUFU's. Measured figures: PERF.md, from
// gsjax_torch/probes.py and chip_smoke.py.
//
// A tile whose window reaches past the table (tile_start inconsistent with
// it) writes NaN for its pixels instead of reading out of bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PIX = 256;      // pixels of a tile
constexpr int THREADS = 256;  // threads per block (8 warps) at every occupancy
constexpr int LANES = 128;    // pairs per chunk
constexpr int ROWS = 8;       // rows per chunk in the table; only row 0 is read
constexpr int ROW_F4 = LANES / 4;  // 16-byte words of a row
constexpr int NBUF = 4;       // staged rows in the ring
constexpr int AHEAD = NBUF - 1;  // chunks in flight ahead of the math
constexpr int MAX_EXP = 10;   // the most exp passes of a swept pair

// WARPS resident warps per SM: blocks per SM, threads per pixel, lanes a thread
template <int WARPS>
struct Occupancy {
  static_assert(WARPS == 8 || WARPS == 24 || WARPS == 48, "occupancies: 8, 24, 48 warps");
  static constexpr int BLOCKS = WARPS / 8;
  static constexpr int SPLIT = WARPS == 8 ? 1 : (WARPS == 24 ? 2 : 8);
  static constexpr int LPT = LANES / SPLIT;
  static constexpr int GROUP = LPT < 64 ? LPT : 64;
  // exp passes a step of the unrolled exp loop: 2 at 80 and 40 registers
  // made ptxas spill on sm_90a (PERF.md)
  static constexpr int EXP_UNROLL = WARPS == 8 ? 2 : 1;
};

// f32(0.1 + j * 1e-7), the probes' exp offsets
__constant__ float c_exp_b[MAX_EXP] = {
    static_cast<float>(0.1 + 0 * 1e-7), static_cast<float>(0.1 + 1 * 1e-7),
    static_cast<float>(0.1 + 2 * 1e-7), static_cast<float>(0.1 + 3 * 1e-7),
    static_cast<float>(0.1 + 4 * 1e-7), static_cast<float>(0.1 + 5 * 1e-7),
    static_cast<float>(0.1 + 6 * 1e-7), static_cast<float>(0.1 + 7 * 1e-7),
    static_cast<float>(0.1 + 8 * 1e-7), static_cast<float>(0.1 + 9 * 1e-7)};
constexpr float PROBE_A = static_cast<float>(-1e-6);

// any exp coefficients: x = expf(a * x - b[j])
struct ExpCoef {
  float a;
  float b[MAX_EXP];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int K_OPS, int K_EXP, bool PROBE, int WARPS>
__global__ void __launch_bounds__(THREADS, Occupancy<WARPS>::BLOCKS)
sol_probe_kernel(const int32_t* __restrict__ tile_start,
                 const float* __restrict__ table,  // (n_chunks, 8, 128)
                 int n_chunks,
                 const ExpCoef coef,
                 float* __restrict__ out) {        // (T, 256)
  static_assert(K_EXP <= MAX_EXP, "ExpCoef holds MAX_EXP offsets");
  using O = Occupancy<WARPS>;
  // the ring; the rest of the dynamic allocation only pins the occupancy
  extern __shared__ float4 s_ring[];  // [NBUF][ROW_F4]
  // the checking instance's exp offsets: a parameter indexed by the loop
  // counter would be copied to local memory
  __shared__ float s_exp_b[PROBE ? 1 : MAX_EXP];
  const int t = blockIdx.x / O::SPLIT;
  const int tid = threadIdx.x;
  const int sub = tid % O::SPLIT;  // this thread's share of its pixel's lanes
  const int pix = (blockIdx.x % O::SPLIT) * (PIX / O::SPLIT) + tid / O::SPLIT;
  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  const int c0 = start / LANES;
  const int nch = (end - c0 * LANES + LANES - 1) / LANES;
  if (start < 0 || end < start || c0 + nch > n_chunks) {  // uniform in the block
    if (sub == 0) out[static_cast<size_t>(t) * PIX + pix] = nanf("");
    return;
  }

  if (!PROBE && tid == 0) {  // published by the chunk loop's barrier
#pragma unroll
    for (int j = 0; j < MAX_EXP; ++j) s_exp_b[j] = coef.b[j];
  }
  auto stage = [&](int ci) {  // warp 0: chunk ci's row into its buffer, one group
    if (tid < 32) {
      if (ci < nch)
        cp_async16(&s_ring[(ci % NBUF) * ROW_F4 + tid],
                   table + static_cast<size_t>(c0 + ci) * ROWS * LANES + 4 * tid);
      cp_async_commit();
    }
  };
#pragma unroll
  for (int ci = 0; ci < AHEAD; ++ci) stage(ci);

  float x[O::LPT];
#pragma unroll
  for (int l = 0; l < O::LPT; ++l) x[l] = 0.0f;

  for (int ci = 0; ci < nch; ++ci) {
    if (tid < 32) cp_async_wait<AHEAD - 1>();  // chunk ci has landed
    __syncthreads();  // ... for the block; chunk ci - 1's buffer is free
    stage(ci + AHEAD);
    const float4* r = s_ring + (ci % NBUF) * ROW_F4;
#pragma unroll
    for (int g = 0; g < O::LPT; g += O::GROUP) {
#pragma unroll
      for (int q = 0; q < O::GROUP / 4; ++q) {
        const float4 v = r[O::SPLIT * (g / 4 + q) + sub];
        x[g + 4 * q] += v.x;
        x[g + 4 * q + 1] += v.y;
        x[g + 4 * q + 2] += v.z;
        x[g + 4 * q + 3] += v.w;
      }
#pragma unroll
      for (int j = 0; j < K_OPS; ++j) {
        const float a = static_cast<float>(1.0000001);
        const float b = static_cast<float>(0.3 + j * 1e-7);
#pragma unroll
        for (int i = 0; i < O::GROUP; ++i) x[g + i] = x[g + i] * a + b;
      }
#pragma unroll(O::EXP_UNROLL)
      for (int j = 0; j < K_EXP; ++j) {
        const float a = PROBE ? PROBE_A : coef.a;
        const float b = PROBE ? c_exp_b[j] : s_exp_b[j];
#pragma unroll
        for (int i = 0; i < O::GROUP; ++i) x[g + i] = expf(a * x[g + i] - b);
      }
    }
  }

  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < O::LPT; ++l) s += x[l];
#pragma unroll
  for (int m = 1; m < O::SPLIT; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (sub == 0) out[static_cast<size_t>(t) * PIX + pix] = s;
}

// one compiled instance and its launch configuration
template <int K_OPS, int K_EXP, bool PROBE, int WARPS>
struct Instance {
  using O = Occupancy<WARPS>;
  static auto kernel() { return &sol_probe_kernel<K_OPS, K_EXP, PROBE, WARPS>; }

  // dynamic shared memory a block asks for: the ring, padded so that
  // exactly O::BLOCKS blocks fit on an SM; 0 until configure() ran
  static int& smem() {
    static int bytes = 0;
    return bytes;
  }

  // set the kernel's shared-memory attributes and check its occupancy
  static int configure() {
    if (smem() > 0) return 0;
    int dev = 0, per_sm = 0, reserved = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    // BLOCKS (bytes + reserved) <= per_sm < (BLOCKS + 1) (bytes + reserved)
    int bytes = (2 * per_sm / (2 * O::BLOCKS + 1) - reserved) / 128 * 128;
    if (bytes < NBUF * ROW_F4 * 16) bytes = NBUF * ROW_F4 * 16;
    e = cudaFuncSetAttribute(kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel(), cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel(), THREADS, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks != O::BLOCKS) return static_cast<int>(cudaErrorInvalidConfiguration);
    smem() = bytes;
    return 0;
  }

  static int launch(const int32_t* ts, const float* tb, int n_chunks, const ExpCoef& coef,
                    float* o, int num_tiles, cudaStream_t stream) {
    const int err = configure();
    if (err) return err;
    const auto k = kernel();
    k<<<num_tiles * O::SPLIT, THREADS, smem(), stream>>>(ts, tb, n_chunks, coef, o);
    return static_cast<int>(cudaGetLastError());
  }

  // registers, local bytes a thread (spills), resident blocks per SM,
  // threads per block, dynamic shared memory per block
  static int info(int* v) {
    const int err = configure();
    if (err) return err;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel());
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel(), THREADS, smem());
    if (e != cudaSuccess) return static_cast<int>(e);
    v[0] = a.numRegs;
    v[1] = static_cast<int>(a.localSizeBytes);
    v[2] = blocks;
    v[3] = THREADS;
    v[4] = smem();
    return 0;
  }
};

// f(Instance<...>{}) for a swept (k_ops, k_exp) pair at WARPS; the checking
// instance of an exp pair unless probe
template <int WARPS, class F>
int with_pair(int k_ops, int k_exp, bool probe, F&& f) {
  if (k_ops == 4 && k_exp == 0) return f(Instance<4, 0, true, WARPS>{});
  if (k_ops == 40 && k_exp == 0) return f(Instance<40, 0, true, WARPS>{});
  if (k_ops == 20 && k_exp == 0) return f(Instance<20, 0, true, WARPS>{});
  if (k_ops == 20 && k_exp == 5)
    return probe ? f(Instance<20, 5, true, WARPS>{}) : f(Instance<20, 5, false, WARPS>{});
  if (k_ops == 20 && k_exp == 10)
    return probe ? f(Instance<20, 10, true, WARPS>{}) : f(Instance<20, 10, false, WARPS>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// every swept pair at every occupancy; cudaErrorInvalidValue for any other
template <class F>
int with_instance(int k_ops, int k_exp, int warps, bool probe, F&& f) {
  switch (warps) {
    case 8: return with_pair<8>(k_ops, k_exp, probe, f);
    case 24: return with_pair<24>(k_ops, k_exp, probe, f);
    case 48: return with_pair<48>(k_ops, k_exp, probe, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool probe_coefs(const ExpCoef& c) {
  bool probe = c.a == PROBE_A;
  for (int j = 0; j < MAX_EXP; ++j) probe = probe && c.b[j] == static_cast<float>(0.1 + j * 1e-7);
  return probe;
}

}  // namespace

// exp_coef: host memory, a then b[0 .. MAX_EXP - 1]; the probes' own
// coefficients select the timed instance, any others the checking one.
// Returns the CUDA error of the launch; cudaErrorInvalidValue for a
// (k_ops, k_exp, warps_per_sm) that has no instance,
// cudaErrorInvalidConfiguration if the instance would not run at its
// occupancy.
extern "C" int gsjax_sol_probe(const void* tile_start, const void* table, void* out,
                               int num_tiles, int n_chunks, int k_ops, int k_exp,
                               int warps_per_sm, const float* exp_coef, void* stream) {
  ExpCoef c;
  c.a = exp_coef[0];
  for (int j = 0; j < MAX_EXP; ++j) c.b[j] = exp_coef[1 + j];
  const auto* ts = static_cast<const int32_t*>(tile_start);
  const auto* tb = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return with_instance(k_ops, k_exp, warps_per_sm, k_exp == 0 || probe_coefs(c),
                       [&](auto inst) {
                         using I = decltype(inst);
                         if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
                         return I::launch(ts, tb, n_chunks, c, o, num_tiles, s);
                       });
}

// info[0..4]: registers a thread, local memory bytes a thread (spills),
// resident blocks per SM, threads per block, dynamic shared memory bytes
// per block, of the instance (the checking one if check != 0).
extern "C" int gsjax_sol_probe_info(int k_ops, int k_exp, int warps_per_sm, int check,
                                    int* info) {
  return with_instance(k_ops, k_exp, warps_per_sm, check == 0 || k_exp == 0,
                       [&](auto inst) { return decltype(inst)::info(info); });
}
