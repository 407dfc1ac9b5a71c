// Front-to-back tile blend shared by the inference and the training
// forward compositing kernels (composite_infer.cu, composite_fwd.cu).
//
// One template, so both kernels run the same recurrence instruction for
// instruction and their colors and transmittance agree bit for bit; the
// training instance also records n_contrib.
//
// Semantics (gsjax/ops/pallas_composite.py, _composite_kernel and
// _composite_infer_kernel):
//   alpha = min(0.99, op * exp(power)), power = -1/2 (a dx^2 + c dy^2) - b dx dy;
//   a pair with power > 0 or alpha < 1/255 is skipped; a pair whose blend
//   would push T below 1e-4 is skipped together with every pair behind it.
// Outputs the tile's rgb (T, 256, 3) and final transmittance (T, 256);
// assemble_image adds the background and crops. The training instance
// also writes n_contrib (T, 256) int32: the local index + 1 of the last
// pair the pixel blended (0 if none), which bounds the backward's replay.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel,
// running the reference CUDA rasterizer's sequential per-pixel recurrence
// (test_T = T (1 - alpha); stop if test_T < 1e-4; else C += c alpha T,
// T = test_T). The block walks its range [tile_start[t], tile_start[t+1])
// of the depth-sorted pairs in batches of 256: each thread gathers one
// pair's gaussian row straight from the per-gaussian (N, 8) table through
// pair_gauss (so no (P, 8) pair table is ever built) into shared memory,
// ~9 KB a batch, and every pixel then walks the batch. The block leaves
// as soon as all 256 pixels are done (__syncthreads_count).
//
// Table row (float32 words): mean x, mean y, conic a, conic b, conic c,
// f16(r) << 16 | f16(g), f16(b) << 16 | f16(opacity), unused. Colors and
// opacity are decoded with __half2float; a value that overflowed f16 reads
// as inf. Built without --use_fast_math and with expf (not __expf): the
// 1/255 and 1e-4 thresholds are sensitive to the last ulp.
//
// Bound on this card: the exp and ~20 float32 operations per evaluated
// (pair, pixel) — at the 1M-gaussian 1080p scene about 7.5e8 evaluations —
// against the bytes of the per-gaussian table, pair_gauss and the output
// (~80 MB, ~25 us at 3.35 TB/s): it is bound by operations, not bytes.
// What the simple design leaves for later: warp-level culling of pairs
// whose footprint misses the warp's pixels, and overlapping the next
// batch's gathers with the current batch's compute.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gsjax {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // threads per block, one per pixel
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

__device__ __forceinline__ float2 decode_f16_pair(float word) {
  const uint32_t bits = __float_as_uint(word);
  const __half hi = __ushort_as_half(static_cast<unsigned short>(bits >> 16));
  const __half lo = __ushort_as_half(static_cast<unsigned short>(bits & 0xFFFFu));
  return make_float2(__half2float(hi), __half2float(lo));
}

// Gathers pair p's gaussian row into shared slot i: geometry (mean x, mean
// y, conic a, conic b), colors and opacity, conic c.
__device__ __forceinline__ void stage_pair(const int32_t* __restrict__ pair_gauss,
                                           const float4* __restrict__ attrs, int p,
                                           int i, float4* s_geom, float4* s_col,
                                           float* s_cc) {
  const int g = pair_gauss[p];
  const float4 a0 = attrs[2 * g];
  const float4 a1 = attrs[2 * g + 1];
  const float2 rg = decode_f16_pair(a1.y);
  const float2 bo = decode_f16_pair(a1.z);
  s_geom[i] = a0;
  s_col[i] = make_float4(rg.x, rg.y, bo.x, bo.y);
  s_cc[i] = a1.x;
}

template <bool kNcon>
__global__ void __launch_bounds__(PIX)
composite_blend_kernel(const int32_t* __restrict__ tile_start,
                       const int32_t* __restrict__ pair_gauss,
                       const float4* __restrict__ attrs,  // (N, 2) float4
                       float* __restrict__ tile_colors,   // (T, 256, 3)
                       float* __restrict__ tile_T,        // (T, 256)
                       int32_t* __restrict__ n_contrib,   // (T, 256), kNcon only
                       int tiles_x) {
  constexpr int BATCH = PIX;  // pairs staged in shared memory per step
  __shared__ float4 s_geom[BATCH];
  __shared__ float4 s_col[BATCH];
  __shared__ float s_cc[BATCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = static_cast<float>((t % tiles_x) * TILE + tid % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + tid / TILE);
  const int start = tile_start[t];
  const int end = tile_start[t + 1];

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int done = 0;
  int last = 0;  // local index + 1 of the last blended pair

  for (int base = start; base < end; base += BATCH) {
    // also the barrier that keeps the previous batch's readers ahead of
    // this batch's writers
    if (__syncthreads_count(done) == PIX) break;
    const int p = base + tid;
    if (p < end) stage_pair(pair_gauss, attrs, p, tid, s_geom, s_col, s_cc);
    __syncthreads();

    const int n = min(BATCH, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float4 gm = s_geom[j];
      const float dx = px - gm.x;
      const float dy = py - gm.y;
      const float power = -0.5f * (gm.z * dx * dx + s_cc[j] * dy * dy) - gm.w * dx * dy;
      if (!(power <= 0.0f)) continue;
      const float4 c = s_col[j];
      const float alpha = fminf(ALPHA_MAX, c.w * expf(power));
      if (!(alpha >= ALPHA_MIN)) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = 1;
        break;
      }
      const float w = alpha * T;
      cr += c.x * w;
      cg += c.y * w;
      cb += c.z * w;
      T = test_T;
      if (kNcon) last = base - start + j + 1;
    }
  }

  const size_t o = static_cast<size_t>(t) * PIX + tid;
  tile_colors[3 * o + 0] = cr;
  tile_colors[3 * o + 1] = cg;
  tile_colors[3 * o + 2] = cb;
  tile_T[o] = T;
  if (kNcon) n_contrib[o] = last;
}

}  // namespace gsjax
