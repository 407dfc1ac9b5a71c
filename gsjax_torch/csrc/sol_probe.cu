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
//   out[t][p] = the sum of x[p][l] over l, lanes added in order 0..127
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
// coefficients made an exp pass 8% slower (PERF.md).
//
// Design: the compositing kernels' skeleton (composite_blend.cuh,
// composite_bwd.cu), so that the floor and the per-pass slope it measures
// are what those kernels can attain: one block of 256 threads per tile, one
// thread per pixel, the tile's window staged through shared memory chunk by
// chunk (row 0, 512 bytes, plain loads between two barriers). The result
// does not depend on the pixel, but every thread does its pixel's full
// work: it carries its 128 lanes in registers and updates them in 2 groups
// of 64 independent chains, which gives each pass 64-way instruction-level
// parallelism. The multiply-add chains are unrolled at compile time as the
// TPU probe unrolled them at trace time: one instance per swept
// (k_ops, k_exp) pair (and the checking one of an exp pair), and any other
// pair is refused. The exp passes run as a loop unrolled by 2: fully
// unrolled, ptxas schedules them with only a few exps in flight and the
// pass measures that schedule's latency instead of expf's rate (PERF.md).
// expf, not __expf, and no fast math.
//
// Bound: sum_t nch_t * 256 * 128 * (1 + 2 k_ops + 3 k_exp) float32
// operations (an exp counted as one) at the H100 SXM data sheet's 67
// TFLOP/s, against sum_t nch_t * 512 bytes of rows plus tile_start and the
// output at its 3.35 TB/s: bound by operations for every swept pair. An
// accurate expf is nine instructions with one MUFU.EX2, so the exp passes
// stay well above that bound.
// Registers: 128 carried floats a thread; __launch_bounds__(PIX, 1) lets
// ptxas take up to 255 registers without spilling, so one block (8 warps)
// runs on an SM at a time and the independent chains, not other warps,
// cover the arithmetic latency. The row loads are not overlapped with the
// math (plain loads between two barriers); the measured floor includes
// them. Measured figures: PERF.md, from gsjax_torch/probes.py.
//
// A tile whose window reaches past the table (tile_start inconsistent with
// it) writes NaN for its pixels instead of reading out of bounds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PIX = 256;     // threads per block, one per pixel
constexpr int LANES = 128;   // pairs per chunk
constexpr int ROWS = 8;      // rows per chunk in the table; only row 0 is read
constexpr int GROUP = 64;    // independent chains updated together
constexpr int MAX_EXP = 10;  // the most exp passes of a swept pair

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

template <int K_OPS, int K_EXP, bool PROBE>
__global__ void __launch_bounds__(PIX, 1)
sol_probe_kernel(const int32_t* __restrict__ tile_start,
                 const float* __restrict__ table,  // (n_chunks, 8, 128)
                 int n_chunks,
                 const ExpCoef coef,
                 float* __restrict__ out) {        // (T, 256)
  static_assert(K_EXP <= MAX_EXP, "ExpCoef holds MAX_EXP offsets");
  __shared__ float s_row[LANES];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  const int c0 = start / LANES;
  const int nch = (end - c0 * LANES + LANES - 1) / LANES;
  float* o = out + static_cast<size_t>(t) * PIX + tid;
  if (start < 0 || end < start || c0 + nch > n_chunks) {  // uniform in the block
    *o = nanf("");
    return;
  }

  float x[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) x[l] = 0.0f;

  for (int ci = 0; ci < nch; ++ci) {
    __syncthreads();  // the previous chunk's readers are done with s_row
    if (tid < LANES) s_row[tid] = table[static_cast<size_t>(c0 + ci) * ROWS * LANES + tid];
    __syncthreads();
#pragma unroll
    for (int g = 0; g < LANES; g += GROUP) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) x[g + i] += s_row[g + i];
#pragma unroll
      for (int j = 0; j < K_OPS; ++j) {
        const float a = static_cast<float>(1.0000001);
        const float b = static_cast<float>(0.3 + j * 1e-7);
#pragma unroll
        for (int i = 0; i < GROUP; ++i) x[g + i] = x[g + i] * a + b;
      }
#pragma unroll 2
      for (int j = 0; j < K_EXP; ++j) {
        const float a = PROBE ? PROBE_A : coef.a;
        const float b = PROBE ? c_exp_b[j] : coef.b[j];
#pragma unroll
        for (int i = 0; i < GROUP; ++i) x[g + i] = expf(a * x[g + i] - b);
      }
    }
  }

  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < LANES; ++l) s += x[l];
  *o = s;
}

template <int K_OPS, int K_EXP>
void launch(const int32_t* tile_start, const float* table, int n_chunks, const ExpCoef& coef,
            float* out, int num_tiles, cudaStream_t stream) {
  if constexpr (K_EXP > 0) {
    bool probe = coef.a == PROBE_A;
    for (int j = 0; j < MAX_EXP; ++j)
      probe = probe && coef.b[j] == static_cast<float>(0.1 + j * 1e-7);
    if (!probe) {
      sol_probe_kernel<K_OPS, K_EXP, false><<<num_tiles, PIX, 0, stream>>>(
          tile_start, table, n_chunks, coef, out);
      return;
    }
  }
  sol_probe_kernel<K_OPS, K_EXP, true><<<num_tiles, PIX, 0, stream>>>(tile_start, table,
                                                                      n_chunks, coef, out);
}

}  // namespace

// exp_coef: host memory, a then b[0 .. MAX_EXP - 1]. Returns the CUDA error
// of the launch; cudaErrorInvalidValue for a (k_ops, k_exp) pair that has
// no instance.
extern "C" int gsjax_sol_probe(const void* tile_start, const void* table, void* out,
                               int num_tiles, int n_chunks, int k_ops, int k_exp,
                               const float* exp_coef, void* stream) {
  ExpCoef c;
  c.a = exp_coef[0];
  for (int j = 0; j < MAX_EXP; ++j) c.b[j] = exp_coef[1 + j];
  const auto* ts = static_cast<const int32_t*>(tile_start);
  const auto* tb = static_cast<const float*>(table);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (num_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (k_ops == 4 && k_exp == 0) {
    launch<4, 0>(ts, tb, n_chunks, c, o, num_tiles, s);
  } else if (k_ops == 40 && k_exp == 0) {
    launch<40, 0>(ts, tb, n_chunks, c, o, num_tiles, s);
  } else if (k_ops == 20 && k_exp == 0) {
    launch<20, 0>(ts, tb, n_chunks, c, o, num_tiles, s);
  } else if (k_ops == 20 && k_exp == 5) {
    launch<20, 5>(ts, tb, n_chunks, c, o, num_tiles, s);
  } else if (k_ops == 20 && k_exp == 10) {
    launch<20, 10>(ts, tb, n_chunks, c, o, num_tiles, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
