// Front-to-back tile blend shared by the inference and the training
// forward compositing kernels (composite_infer.cu, composite_fwd.cu), and
// the helpers that the backward kernel (composite_bwd.cu) shares with it:
// the f16 decode, cp.async and the per-warp cull's footprint box.
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
// Layout: one block of 256 threads per 16x16 tile, one thread per pixel,
// running the reference CUDA rasterizer's sequential per-pixel recurrence
// (test_T = T (1 - alpha); stop if test_T < 1e-4; else C += c alpha T,
// T = test_T); warp w holds the 16x2 strip of pixel rows 2w and 2w + 1.
//
// What bounds it, and what each part of the design does about it. At the
// 1M-gaussian 1080p scene about 7.5e8 (pair, pixel) evaluations up to each
// pixel's exit, the exp and ~20 float32 operations each, against ~80 MB of
// bytes (~25 us at 3.35 TB/s): it is bound by instruction issue. The first
// version walked every pair of its 256-pair batches in every warp up to
// the warp's last exit, each lane on its own (1.25 ms on an H100):
//
// - The walk. Most pairs of a tile miss most of its 16x2 strips. Each
//   staged pair gets its footprint_box once, from the thread that stages
//   it; a warp tests 32 staged slots at once against its strip, and a
//   ballot gives the live slots, which it walks in depth order. The cull is
//   exact: a pair whose box misses the strip has power > 0 or alpha <
//   1/255 at each of its pixels, so it neither blends nor ends a pixel, and
//   the pairs left run the same arithmetic in the same order: colors, T
//   and n_contrib equal the walk without the cull bit for bit (the check
//   instance, kCull false).
// - Warp exit. A warp whose 32 lanes are done stops walking: a vote after
//   each 32 staged slots (a vote after each step cost 10% of the kernel's
//   time on an H100; the steps that follow a warp's last exit inside its
//   32 slots skip the arithmetic). The block leaves once all 256 pixels
//   are done (__syncthreads_count).
// - Staging. Batches of 64 pairs (two 32-bit ballots), double-buffered in
//   shared memory: while batch k is walked, the two 16-byte gaussian rows
//   of batch k + 1 arrive by cp.async (TMA cannot gather rows by index on
//   sm_90a) and the pair_gauss indices of batch k + 2 load into registers;
//   batch k + 1's f16 colors and opacity are decoded, and its boxes
//   computed, after the copy lands. One barrier per batch.
//
// Table row (float32 words): mean x, mean y, conic a, conic b, conic c,
// f16(r) << 16 | f16(g), f16(b) << 16 | f16(opacity), unused. Colors and
// opacity are decoded as gsjax's Pallas kernels decode them
// (_f16_pair_rows): integer arithmetic on the 15 exponent and mantissa
// bits, so a value that overflowed f16 (the inf pattern) reads as 65536
// and stays finite, and a zero or denormal half reads as +0. Built without
// --use_fast_math and with expf (not __expf): the 1/255 and 1e-4
// thresholds are sensitive to the last ulp.

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
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int FWD_BATCH = 64;       // pairs staged per step of the blend (two ballots)
constexpr int FWD_MIN_BLOCKS = 6;   // blocks per SM: caps the blend's registers at 40

// One f16 bit pattern h (low 16 bits) as float32: sign | (em + 112 << 10)
// << 13 on its 15 exponent and mantissa bits em, 0 for em < 1024. Exact
// for every normal f16; the inf and NaN patterns land on finite floats
// (inf reads 65536), as in gsjax's decode.
__device__ __forceinline__ float decode_f16(uint32_t h) {
  const uint32_t em = h & 0x7FFFu;
  return __uint_as_float(em < 1024u ? 0u : ((h & 0x8000u) << 16) | ((em + (112u << 10)) << 13));
}

__device__ __forceinline__ float2 decode_f16_pair(float word) {
  const uint32_t bits = __float_as_uint(word);
  return make_float2(decode_f16(bits >> 16), decode_f16(bits & 0xFFFFu));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A box (x lo, x hi, y lo, y hi) holding every pixel that the pair (mean
// gm.x/y, conic gm.z, gm.w, cc, opacity op) can contribute to. A pixel
// contributes only if op e^power >= 1/255 with power = -d'Qd / 2 <= 0,
// that is d'Qd <= 2 tau with tau = ln(255 op); on that ellipse |dx| <=
// sqrt(2 tau c / det) and |dy| <= sqrt(2 tau a / det), det = ac - b^2.
// The kernel's power rounds, most where the terms of d'Qd cancel: its
// error is below ~1e-6 ac / det of |power|, so tau widens by a relative
// 1e-3 + 4e-6 ac / det and 1e-5 (the exp and the 1/255 cut), and each
// half-width by one pixel. Below opacity 1/255 no pixel contributes (the
// empty box); anything non-finite, det <= 0, a <= 0, c <= 0 or a box
// wider than 1e5 pixels gives the full plane. cuda_composite.
// footprint_box_plain mirrors this line for line: each product and sum is
// rounded on its own (__fmul_rn, __fadd_rn, ...), so nvcc contracts none
// into an FMA and every operation rounds as torch's does; only logf and
// torch.log may differ, by an ulp, far inside the 1e-3 widening.
__device__ __forceinline__ float4 footprint_box(float4 gm, float cc, float op) {
  const float inf = __int_as_float(0x7f800000);
  const float4 full = make_float4(-inf, inf, -inf, inf);
  const float a = gm.z, b = gm.w, c = cc;
  if (!(isfinite(gm.x) && isfinite(gm.y) && isfinite(a) && isfinite(b) && isfinite(c) &&
        isfinite(op)))
    return full;
  if (!(op >= ALPHA_MIN)) return make_float4(inf, -inf, inf, -inf);
  const float det = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b));
  if (!(a > 0.0f && c > 0.0f && det > 0.0f)) return full;
  const float tau = fmaxf(logf(__fmul_rn(255.0f, op)), 0.0f);
  const float widen = __fadd_rn(1.001f, __fmul_rn(4e-6f, __fdiv_rn(__fmul_rn(a, c), det)));
  const float tau2 = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, tau), widen), 1e-5f);
  const float hx = __fadd_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(tau2, c), det)), 1.0f);
  const float hy = __fadd_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(tau2, a), det)), 1.0f);
  if (!(hx < 1e5f && hy < 1e5f && fabsf(gm.x) < 1e5f && fabsf(gm.y) < 1e5f)) return full;
  return make_float4(gm.x - hx, gm.x + hx, gm.y - hy, gm.y + hy);
}

// One staged pair in shared memory: the two table rows as copied, the
// decoded colors and opacity, and the footprint box. One struct, so a step
// of the walk finds the three words it reads at one address and fixed
// offsets (separate arrays cost it ~10 more address instructions a step at
// the register cap).
struct __align__(16) StagedPair {
  float4 geom;  // mean x, mean y, conic a, conic b
  float4 row1;  // conic c, f16(r)|f16(g), f16(b)|f16(op), unused
  float4 col;   // r, g, b, opacity
  float4 box;   // footprint_box (culling instances)
};

// kNcon: also write n_contrib (the training instance). kCull: the
// per-warp cull (every instance on the render and training paths); without
// it, the check instance that walks every pair.
template <bool kNcon, bool kCull>
__global__ void __launch_bounds__(PIX, FWD_MIN_BLOCKS)
composite_blend_kernel(const int32_t* __restrict__ tile_start,
                       const int32_t* __restrict__ pair_gauss,
                       const float4* __restrict__ attrs,  // (N, 2) float4
                       float* __restrict__ tile_colors,   // (T, 256, 3)
                       float* __restrict__ tile_T,        // (T, 256)
                       int32_t* __restrict__ n_contrib,   // (T, 256), kNcon only
                       int tiles_x) {
  __shared__ StagedPair s_pair[2][FWD_BATCH];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx0 = (t % tiles_x) * TILE;
  const int ty0 = (t / tiles_x) * TILE;
  const float px = static_cast<float>(tx0 + tid % TILE);
  const float py = static_cast<float>(ty0 + tid / TILE);
  const int start = tile_start[t];
  const int n = tile_start[t + 1] - start;
  const int nbatch = (n + FWD_BATCH - 1) / FWD_BATCH;

  // batch k holds the tile's local pairs [k FWD_BATCH, min(n, (k + 1)
  // FWD_BATCH)); thread tid < FWD_BATCH stages slot tid of every batch
  auto slot_live = [&](int k) {
    return tid < FWD_BATCH && k < nbatch && k * FWD_BATCH + tid < n;
  };
  auto load_gauss = [&](int k) {
    return slot_live(k) ? pair_gauss[start + k * FWD_BATCH + tid] : -1;
  };
  auto issue_copy = [&](int k, int g) {
    if (g >= 0) {
      cp_async16(&s_pair[k & 1][tid].geom, attrs + 2 * static_cast<size_t>(g));
      cp_async16(&s_pair[k & 1][tid].row1, attrs + 2 * static_cast<size_t>(g) + 1);
    }
    cp_async_commit();
  };
  auto decode = [&](int k) {  // after this thread's copy of batch k landed
    if (slot_live(k)) {
      StagedPair& sp = s_pair[k & 1][tid];
      const float4 r = sp.row1;
      const float2 rg = decode_f16_pair(r.y);
      const float2 bo = decode_f16_pair(r.z);
      sp.col = make_float4(rg.x, rg.y, bo.x, bo.y);
      if (kCull) sp.box = footprint_box(sp.geom, r.x, bo.y);
    }
  };

  issue_copy(0, load_gauss(0));
  int g_next = load_gauss(1);  // this thread's gaussian of the next batch to copy
  cp_async_wait_all();
  decode(0);

  // the warp's strip: columns x0 .. x0 + 15, rows y0 and y0 + 1
  const float x0 = static_cast<float>(tx0);
  const float y0 = static_cast<float>(ty0 + 2 * (tid >> 5));
  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  int done = 0;
  bool warp_done = false;
  int last = 0;  // local index + 1 of the last blended pair

  for (int k = 0; k < nbatch; ++k) {
    const int b = k & 1;
    // batch k is decoded, and every warp is done with batch k - 1, whose
    // buffer b ^ 1 batch k + 1 now takes
    if (__syncthreads_count(done) == PIX) break;
    issue_copy(k + 1, g_next);
    g_next = load_gauss(k + 2);

    const int base = k * FWD_BATCH;
    const int nb = min(FWD_BATCH, n - base);
    for (int h = 0; h < 2 && h * 32 < nb && !warp_done; ++h) {
      const int sl = h * 32 + lane;
      bool ok = sl < nb;
      if (kCull && ok) {
        const float4 bx = s_pair[b][sl].box;
        ok = bx.x <= x0 + (TILE - 1) && bx.y >= x0 && bx.z <= y0 + 1.0f && bx.w >= y0;
      }
      unsigned live = __ballot_sync(FULL, ok);  // slot h * 32 + i at bit i
      while (live) {
        const int j = h * 32 + __ffs(live) - 1;
        live &= live - 1u;
        if (!done) {
          const StagedPair& sp = s_pair[b][j];
          const float4 gm = sp.geom;
          const float dx = px - gm.x;
          const float dy = py - gm.y;
          const float power = -0.5f * (gm.z * dx * dx + sp.row1.x * dy * dy) - gm.w * dx * dy;
          if (power <= 0.0f) {
            const float4 c = sp.col;
            const float alpha = fminf(ALPHA_MAX, c.w * expf(power));
            if (alpha >= ALPHA_MIN) {
              const float test_T = T * (1.0f - alpha);
              if (test_T < T_EPS) {
                done = 1;
              } else {
                const float w = alpha * T;
                cr += c.x * w;
                cg += c.y * w;
                cb += c.z * w;
                T = test_T;
                if (kNcon) last = base + j + 1;
              }
            }
          }
        }
      }
      warp_done = __all_sync(FULL, done);
    }
    cp_async_wait_all();
    decode(k + 1);
  }

  const size_t o = static_cast<size_t>(t) * PIX + tid;
  tile_colors[3 * o + 0] = cr;
  tile_colors[3 * o + 1] = cg;
  tile_colors[3 * o + 2] = cb;
  tile_T[o] = T;
  if (kNcon) n_contrib[o] = last;
}

}  // namespace gsjax
