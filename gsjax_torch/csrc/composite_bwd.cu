// Backward compositing kernel for Hopper (sm_90a): per-pair gradients.
//
// Replaces the Pallas TPU kernel gsjax/ops/pallas_composite.py:
// _composite_bwd_kernel (launched from composite_pallas_grads). For every
// sorted pair it writes the nine gradients of the loss with respect to the
// pair's gaussian as seen by that tile — mean x, mean y, conic a, b, c,
// opacity, r, g, b — into row i of a zero-initialised (P, 9) float32
// table; the reduction to gaussians is plain torch
// (cuda_composite.reduce_pair_grads).
//
// Math (pallas_composite.py:859-913). A pixel's forward blends its
// contributing pairs i in depth order: C = sum_i c_i a_i T_i, T_{i+1} =
// T_i (1 - a_i), final T_N. With V = dL/dC and u = dL/dT_N,
//   dL/da_i = T_i (c_i . V) - (S_i + T_N u) / (1 - a_i),
//   S_i     = sum_{j > i} a_j T_j (c_j . V),
//   dL/dc_i = a_i T_i V.
// a_i = min(0.99, op e^power): past the clamp a_i is constant in op and
// power, so only dL/dc flows there. Otherwise dL/dpower = a_i dL/da_i
// (g_pow) and dL/dop = e^power dL/da_i = g_pow / op. The pixel sums of
// g_pow, dx g_pow, dy g_pow, dx^2 g_pow, dx dy g_pow, dy^2 g_pow, a T V
// are what a pair needs; the per-pair coefficients factor out of them:
//   d mean x = a S_dx + b S_dy,   d mean y = c S_dy + b S_dx,
//   d conic a = -S_dxdx / 2,  d conic b = -S_dxdy,  d conic c = -S_dydy / 2.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel.
// The block walks from its largest n_contrib back to the tile's start in
// batches of 64 pairs staged in shared memory. Each pixel replays the
// forward back to front: it rebuilds T before a pair by dividing by
// (1 - a), safe since a <= 0.99, and carries S. A pair passes the same
// tests as in the forward (power <= 0, alpha >= 1/255) and must lie
// before the pixel's n_contrib. Each pair's nine pixel sums come from a
// fixed-order reduction: an xor-butterfly of warp shuffles (skipped, with
// a zero partial, when no lane of the warp contributes), the 8 warp
// partials kept in shared memory and summed in warp order by one thread
// per pair at the end of the batch. No atomics, so the table is the same
// bit for bit from run to run.
//
// Bound on this card: operations. At the 1M-gaussian 1080p scene the
// replay evaluates about as many (pair, pixel) as the forward, ~7.5e8,
// each ~45 float32 operations where the pair contributes (and the warp
// butterfly: 9 x 5 shuffle-adds per warp and pair), against ~130 MB of
// bytes (the (P, 9) table written once, the gaussian table, pair_gauss
// and the per-pixel inputs read once) — ~40 us at 3.35 TB/s. What the
// simple design leaves for later: a transposed multi-value warp
// reduction (fewer shuffles), warp-level culling of pairs that miss the
// warp's pixels, and overlapping the next batch's gathers.

#include "composite_blend.cuh"

namespace {

using namespace gsjax;

constexpr int BATCH = 64;           // pairs staged per step
constexpr int NWARP = PIX / 32;     // warps per block
constexpr int NSUM = 9;             // pixel sums per pair
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ pair_gauss,
                     const float4* __restrict__ attrs,       // (N, 2) float4
                     const float* __restrict__ d_colors,     // (T, 256, 3)
                     const float* __restrict__ d_T,          // (T, 256)
                     const float* __restrict__ final_T,      // (T, 256)
                     const int32_t* __restrict__ n_contrib,  // (T, 256)
                     float* __restrict__ pair_grads,         // (P, 9), zeroed
                     int tiles_x) {
  __shared__ float4 s_geom[BATCH];
  __shared__ float4 s_col[BATCH];
  __shared__ float s_cc[BATCH];
  __shared__ float s_part[BATCH][NWARP][NSUM];
  __shared__ int s_maxn;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = static_cast<float>((t % tiles_x) * TILE + tid % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + tid / TILE);
  const int start = tile_start[t];
  const size_t o = static_cast<size_t>(t) * PIX + tid;

  const int ncon = n_contrib[o];
  if (tid == 0) s_maxn = 0;
  __syncthreads();
  const int wmax = __reduce_max_sync(FULL, ncon);
  if (lane == 0) atomicMax(&s_maxn, wmax);
  __syncthreads();
  const int maxn = s_maxn;

  const float vr = d_colors[3 * o + 0];
  const float vg = d_colors[3 * o + 1];
  const float vb = d_colors[3 * o + 2];
  const float TN = final_T[o];
  const float tn_u = TN * d_T[o];
  float T = TN;     // transmittance after the pairs replayed so far
  float S = 0.0f;   // sum of a T (c . V) over the pairs replayed so far

  for (int hi = start + maxn; hi > start; hi -= BATCH) {
    const int lo = max(start, hi - BATCH);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's readers are done with shared memory
    if (tid < n) stage_pair(pair_gauss, attrs, lo + tid, tid, s_geom, s_col, s_cc);
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float sums[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) sums[k] = 0.0f;
      bool contrib = false;
      const float4 gm = s_geom[j];
      const float dx = px - gm.x;
      const float dy = py - gm.y;
      const float power = -0.5f * (gm.z * dx * dx + s_cc[j] * dy * dy) - gm.w * dx * dy;
      if (lo + j - start < ncon && power <= 0.0f) {
        const float4 c = s_col[j];
        const float raw = c.w * expf(power);
        const float alpha = fminf(ALPHA_MAX, raw);
        if (alpha >= ALPHA_MIN) {
          contrib = true;
          const float one_m = 1.0f - alpha;
          T = T / one_m;  // transmittance before this pair
          const float w = alpha * T;
          const float cdotv = c.x * vr + c.y * vg + c.z * vb;
          const float dalpha = T * cdotv - (S + tn_u) / one_m;
          S += w * cdotv;
          const float g_pow = raw <= ALPHA_MAX ? alpha * dalpha : 0.0f;
          sums[0] = g_pow;
          sums[1] = dx * g_pow;
          sums[2] = dy * g_pow;
          sums[3] = dx * dx * g_pow;
          sums[4] = dx * dy * g_pow;
          sums[5] = dy * dy * g_pow;
          sums[6] = vr * w;
          sums[7] = vg * w;
          sums[8] = vb * w;
        }
      }
      if (__any_sync(FULL, contrib)) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) {
          float v = sums[k];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
          sums[k] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NSUM; ++k) s_part[j][warp][k] = sums[k];
      }
    }
    __syncthreads();

    if (tid < n) {
      float s[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) acc += s_part[tid][w][k];
        s[k] = acc;
      }
      const float4 gm = s_geom[tid];  // mean x, mean y, conic a, conic b
      const float cc = s_cc[tid];
      const float op = s_col[tid].w;
      float* row = pair_grads + static_cast<size_t>(lo + tid) * NSUM;
      row[0] = gm.z * s[1] + gm.w * s[2];  // mean x
      row[1] = cc * s[2] + gm.w * s[1];    // mean y
      row[2] = -0.5f * s[3];               // conic a
      row[3] = -s[4];                      // conic b
      row[4] = -0.5f * s[5];               // conic c
      row[5] = s[0] / fmaxf(op, 1e-12f);   // opacity
      row[6] = s[6];                       // r
      row[7] = s[7];                       // g
      row[8] = s[8];                       // b
    }
  }
}

}  // namespace

extern "C" int gsjax_composite_bwd(const void* tile_start, const void* pair_gauss,
                                   const void* gauss_attrs, const void* d_colors,
                                   const void* d_T, const void* final_T,
                                   const void* n_contrib, void* pair_grads, int num_tiles,
                                   int tiles_x, void* stream) {
  if (num_tiles > 0) {
    composite_bwd_kernel<<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tile_start), static_cast<const int32_t*>(pair_gauss),
        static_cast<const float4*>(gauss_attrs), static_cast<const float*>(d_colors),
        static_cast<const float*>(d_T), static_cast<const float*>(final_T),
        static_cast<const int32_t*>(n_contrib), static_cast<float*>(pair_grads), tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
