// Backward compositing kernel for Hopper (sm_90a): per-pair gradients.
//
// Replaces the Pallas TPU kernel gsjax/ops/pallas_composite.py:
// _composite_bwd_kernel (launched from composite_pallas_grads). For every
// sorted pair it writes the nine gradients of the loss with respect to the
// pair's gaussian as seen by that tile — mean x, mean y, conic a, b, c,
// opacity, r, g, b — into row i of a zero-initialised table; the reduction
// to gaussians is plain torch (cuda_composite.reduce_pair_grads). Rows of
// pairs that no pixel blends stay zero. The table is one of three outputs,
// as gsjax's grad_dtype and grad_reduce select them:
//
// - OUT_F32: (P, 9) float32 (grad_dtype "float32");
// - OUT_BF16_UP: (P, 5) int32, the nine float32 values rounded to bf16
//   and packed in pairs (mx, my), (ca, cb), (cc, op), (r, g), (b, 0), the
//   first of a pair in the high half — gsjax's packed mode of
//   grad_reduce "sort" (_pack_bf16_pair_rows, pallas_composite.py:268),
//   which rounds the magnitude half up: (bits + 0x8000) >> 16;
// - OUT_BF16_EVEN: the same layout rounded to nearest even, as gsjax's
//   bfloat16 output buffer under grad_reduce "gather" (.astype, :955).
//
// The packed modes compute the same float32 values as OUT_F32 and round
// them in the finish loop, so their words are OUT_F32's table packed.
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
// Layout: one block of 256 threads per 16x16 tile, one thread per pixel;
// warp w holds the 16x2 strip of pixel rows 2w and 2w + 1. Each pixel
// replays the forward back to front: it rebuilds T before a pair by
// dividing by (1 - a), safe since a <= 0.99, and carries S. A pair passes
// the forward's tests (power <= 0, alpha >= 1/255) and must lie before the
// pixel's n_contrib. The (pair, pixel) step is the same float32
// expression sequence as the first version of this kernel (expf, not
// __expf; no --use_fast_math), so the set of contributing (pair, pixel)
// is unchanged; only the order of the pixel sums changed.
//
// What bounds it, and what each part of the design does about it. At the
// 1M-gaussian 1080p scene a pixel walks ~350 pairs, 7.3e8 (pair, pixel)
// steps of which 9.5e7 contribute, against ~225 MB of bytes (67 us at
// 3.35 TB/s): it is bound by instruction issue, and the first version
// spent most of it outside the arithmetic (3.34 ms on an H100):
//
// - The walk. A warp steps through only the pairs whose footprint can
//   reach its strip: each staged pair gets a box that holds every pixel
//   it can contribute to (footprint_box: the 1/255 contour of its
//   conic, widened for float rounding; the full plane when in doubt),
//   the warp's lanes test 32 pairs at once against the strip and a
//   ballot gives the live slots. A warp also stops at its own largest
//   n_contrib, not the tile's. It still takes every block barrier. The
//   walk left is what bounds the kernel now: a step with no contributing
//   lane still issues the live-mask pop, the addresses, dx, dy, power and
//   the vote.
// - Warp sums. A 5-step xor butterfly per pixel sum cost 45 shuffles per
//   (pair, warp) with a contributing lane, and the card retires one warp
//   shuffle per clock per SM. Now a warp collects the 9 per-lane values
//   of GROUP pairs that have a contributing lane and reduce-scatters
//   them: at each halving step a lane keeps one half of the pairs and
//   adds its partner's copy of that half; a butterfly over the lanes left
//   finishes the 9 sums of the lane's pair. The first halving runs as the
//   second half of the slots fills, so 45 values, not 72, are live at
//   once. GROUP 8: 36 + 18 + 9 + 2 x 9 = 81 shuffles per 8 pairs. The
//   order is fixed, so the table is the same bit for bit from run to run.
// - Registers. 80 a thread, no spills (__launch_bounds__ with 3 blocks):
//   24 warps per SM. The register file, not shared memory, sets it.
// - Partials. A warp writes its partial sums of a pair only when it
//   reduced that pair, and marks it in a per-pair bit mask (an exact
//   shared-memory atomicOr). No float atomics.
// - Finish. All 256 threads turn a batch's partials into table rows: each
//   output word of the batch's contiguous rows sums the marked warps'
//   partials in warp order (two 16-byte loads), with little divergence;
//   the stores are coalesced. A pair no warp marked writes nothing. A
//   packed word takes two gradients, rounded and packed in registers.
// - Staging. Batches of 64 pairs run from the tile's end toward its
//   start, double-buffered in shared memory: while batch k replays, the
//   two 16-byte gaussian rows of batch k + 1 arrive by cp.async (TMA
//   cannot gather rows by index on sm_90a) and the pair_gauss indices of
//   batch k + 2 load into registers; batch k + 1's f16 colors and
//   opacity are decoded, and its boxes computed, after the copy lands.
//
// gsjax_composite_bwd launches the training instance. gsjax_composite_bwd_
// counts launches the two check instances, never on the training path:
// the training instance that also writes each pixel's count of
// contributing pairs, and the same without the cull. Their counts must be
// equal on every pixel and their tables bit for bit: the cull, on the
// card's own arithmetic, lost nothing.

#include "composite_blend.cuh"

namespace {

using namespace gsjax;

constexpr int BATCH = 64;            // pairs staged per step (two 32-bit ballots)
constexpr int NWARP = PIX / 32;      // warps per block
constexpr int NSUM = 9;              // pixel sums per pair
constexpr int PART_W = NSUM * NWARP + 4;  // a pair's partials, sum-major; 16-byte rows
constexpr int GROUP = 8;             // pairs per warp reduce-scatter
constexpr int MIN_BLOCKS = 3;        // blocks per SM: caps registers at 80
constexpr int NPACK = (NSUM + 1) / 2;  // int32 words of a packed bf16 row

// the table's output modes (see the header)
constexpr int OUT_F32 = 0;
constexpr int OUT_BF16_UP = 1;
constexpr int OUT_BF16_EVEN = 2;

// bf16 bits of x in the low 16 bits: the magnitude rounded half up
// (OUT_BF16_UP, gsjax's integer rule, wrapping as its int32 add does) or
// to nearest even, a NaN as the quiet NaN of its sign (OUT_BF16_EVEN, as
// XLA converts to bfloat16)
template <int kOut>
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  if constexpr (kOut == OUT_BF16_UP) {
    return (u + 0x8000u) >> 16;
  } else {
    return x != x ? ((u >> 16) & 0x8000u) | 0x7FC0u : (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
  }
}

// Reduce-scatter of v = M pairs x NSUM values over the lanes that differ
// in bits OFF, OFF/2, ..., 1. Each halving step keeps the half of the
// pairs picked by the lane's bit and adds the partner's copy of it; when
// one pair is left, a butterfly over the remaining bits sums its NSUM
// values. On return v[0 .. NSUM) holds the sums of the pair picked by the
// lane's bits OFF .. OFF / (M / 2).
template <int M, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (M > 1) {
    constexpr int H = (M / 2) * NSUM;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
    reduce_scatter<M / 2, OFF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < NSUM; ++q) v[q] += __shfl_xor_sync(FULL, v[q], off);
    }
  }
}

template <bool kCull, bool kCount, int kOut>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
composite_bwd_kernel(const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ pair_gauss,
                     const float4* __restrict__ attrs,       // (N, 2) float4
                     const float* __restrict__ d_colors,     // (T, 256, 3)
                     const float* __restrict__ d_T,          // (T, 256)
                     const float* __restrict__ final_T,      // (T, 256)
                     const int32_t* __restrict__ n_contrib,  // (T, 256)
                     void* __restrict__ pair_grads,          // (P, 9) or (P, 5), zeroed
                     int32_t* __restrict__ counts,           // (T, 256), kCount only
                     int tiles_x) {
  static_assert(GROUP == 2 || GROUP == 4 || GROUP == 8, "group size");
  constexpr int LANES_PER_PAIR = 32 / GROUP;  // lanes holding one pair's sums after the scatter
  constexpr int HALF = GROUP / 2;             // slots filled before the first halving

  __shared__ float4 s_geom[2][BATCH];  // mean x, mean y, conic a, conic b
  __shared__ float4 s_row1[2][BATCH];  // conic c, f16(r)|f16(g), f16(b)|f16(op), unused
  __shared__ float4 s_col[2][BATCH];   // r, g, b, opacity
  __shared__ float4 s_box[2][BATCH];   // footprint_box (kCull)
  __shared__ __align__(16) float s_part[BATCH][PART_W];  // [pair][sum * NWARP + warp]
  __shared__ unsigned s_wrote[2][BATCH];  // per pair: bit w set when warp w wrote a partial
  __shared__ int s_maxn;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx0 = (t % tiles_x) * TILE;
  const int ty0 = (t / tiles_x) * TILE;
  const float px = static_cast<float>(tx0 + tid % TILE);
  const float py = static_cast<float>(ty0 + tid / TILE);
  const int start = tile_start[t];
  const size_t o = static_cast<size_t>(t) * PIX + tid;

  const int ncon = n_contrib[o];
  if (tid == 0) s_maxn = 0;
  if (tid < 2 * BATCH) s_wrote[tid / BATCH][tid % BATCH] = 0u;
  __syncthreads();
  const int wmax = __reduce_max_sync(FULL, ncon);
  if (lane == 0) atomicMax(&s_maxn, wmax);
  __syncthreads();
  const int maxn = s_maxn;
  const int nbatch = (maxn + BATCH - 1) / BATCH;

  // batch k holds the tile's local pairs [lo(k), hi(k)); thread tid < BATCH
  // stages slot tid of every batch
  auto batch_lo = [&](int k) { return max(0, maxn - (k + 1) * BATCH); };
  auto batch_hi = [&](int k) { return maxn - k * BATCH; };
  auto slot_live = [&](int k) {
    return tid < BATCH && k < nbatch && batch_lo(k) + tid < batch_hi(k);
  };
  auto load_gauss = [&](int k) { return slot_live(k) ? pair_gauss[start + batch_lo(k) + tid] : -1; };
  auto issue_copy = [&](int k, int g) {
    if (g >= 0) {
      cp_async16(&s_geom[k & 1][tid], attrs + 2 * static_cast<size_t>(g));
      cp_async16(&s_row1[k & 1][tid], attrs + 2 * static_cast<size_t>(g) + 1);
    }
    cp_async_commit();
  };
  auto decode = [&](int k) {
    if (slot_live(k)) {
      const float4 r = s_row1[k & 1][tid];
      const float2 rg = decode_f16_pair(r.y);
      const float2 bo = decode_f16_pair(r.z);
      s_col[k & 1][tid] = make_float4(rg.x, rg.y, bo.x, bo.y);
      if (kCull) s_box[k & 1][tid] = footprint_box(s_geom[k & 1][tid], r.x, bo.y);
    }
  };

  issue_copy(0, load_gauss(0));
  int g_next = load_gauss(1);  // this thread's gaussian of the next batch to copy
  cp_async_wait_all();
  __syncthreads();
  decode(0);

  const float vr = d_colors[3 * o + 0];
  const float vg = d_colors[3 * o + 1];
  const float vb = d_colors[3 * o + 2];
  const float TN = final_T[o];
  const float tn_u = TN * d_T[o];
  float T = TN;     // transmittance after the pairs replayed so far
  float S = 0.0f;   // sum of a T (c . V) over the pairs replayed so far
  int n_live = 0;   // contributing pairs (kCount)

  for (int k = 0; k < nbatch; ++k) {
    const int b = k & 1;
    // batch k is decoded; batch k - 1's finish is done with buffer b ^ 1,
    // its masks and the partials
    __syncthreads();
    issue_copy(k + 1, g_next);
    g_next = load_gauss(k + 2);
    if (tid < BATCH) s_wrote[b ^ 1][tid] = 0u;  // for batch k + 1

    const int llo = batch_lo(k);
    const float4* geom = s_geom[b];
    const float4* row1 = s_row1[b];
    const float4* col = s_col[b];
    // live slots of this warp, slot j at bit 63 - j (the lowest set bit is
    // the deepest pair left): before its largest n_contrib and, with the
    // cull, with a box that meets its strip
    const int nw = min(batch_hi(k), wmax) - llo;
    unsigned long long live = 0ull;
    if (nw > 0) {
      if (kCull) {
        const float x0 = static_cast<float>(tx0);
        const float y0 = static_cast<float>(ty0 + 2 * warp);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int sl = h * 32 + lane;
          bool ok = false;
          if (sl < nw) {
            const float4 bx = s_box[b][sl];
            ok = bx.x <= x0 + (TILE - 1) && bx.y >= x0 && bx.z <= y0 + 1.0f && bx.w >= y0;
          }
          const unsigned bits = __brev(__ballot_sync(FULL, ok));
          live |= h == 0 ? static_cast<unsigned long long>(bits) << 32 : bits;
        }
      } else {
        live = nw >= BATCH ? ~0ull : ~0ull << (64 - nw);
      }
    }
    while (live) {
      // fill GROUP slots with pairs that have a contributing lane; the
      // second half of the slots is folded into the first as it fills
      float v[HALF * NSUM];
      int slot[GROUP];
#pragma unroll
      for (int s = 0; s < GROUP; ++s) {
        float tmp[NSUM];
        float* out = s < HALF ? v + s * NSUM : tmp;
#pragma unroll
        for (int q = 0; q < NSUM; ++q) out[q] = 0.0f;
        slot[s] = -1;
        while (live) {
          const int jj = 64 - __ffsll(live);
          live &= live - 1ull;
          bool contrib = false;
          const float4 gm = geom[jj];
          const float dx = px - gm.x;
          const float dy = py - gm.y;
          const float power = -0.5f * (gm.z * dx * dx + row1[jj].x * dy * dy) - gm.w * dx * dy;
          if (llo + jj < ncon && power <= 0.0f) {
            const float4 c = col[jj];
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
              out[0] = g_pow;
              out[1] = dx * g_pow;
              out[2] = dy * g_pow;
              out[3] = dx * dx * g_pow;
              out[4] = dx * dy * g_pow;
              out[5] = dy * dy * g_pow;
              out[6] = vr * w;
              out[7] = vg * w;
              out[8] = vb * w;
              if (kCount) ++n_live;
            }
          }
          if (__any_sync(FULL, contrib)) {
            slot[s] = jj;
            break;
          }
        }
        if (s >= HALF) {  // the first halving step, for slots s - HALF and s
          const bool upper = (lane & 16) != 0;
          float* lo = v + (s - HALF) * NSUM;
#pragma unroll
          for (int q = 0; q < NSUM; ++q) {
            const float send = upper ? lo[q] : out[q];
            const float keep = upper ? out[q] : lo[q];
            lo[q] = keep + __shfl_xor_sync(FULL, send, 16);
          }
        }
      }
      if (slot[0] < 0) break;  // no pair left with a contributing lane
      reduce_scatter<HALF, 8>(v, lane);
      if (lane % LANES_PER_PAIR == 0) {
        const int p = lane / LANES_PER_PAIR;
        int js = slot[0];
#pragma unroll
        for (int s = 1; s < GROUP; ++s) js = p == s ? slot[s] : js;
        if (js >= 0) {
#pragma unroll
          for (int q = 0; q < NSUM; ++q) s_part[js][q * NWARP + warp] = v[q];
          atomicOr(&s_wrote[b][js], 1u << warp);
        }
      }
    }

    cp_async_wait_all();
    __syncthreads();  // batch k's partials and masks are written; batch k + 1 has landed

    // finish batch k: word f of its rows (pair llo + f / ROW_W, column
    // f % ROW_W; a packed column holds gradients 2c and 2c + 1)
    constexpr int ROW_W = kOut == OUT_F32 ? NSUM : NPACK;
    const int nwords = (batch_hi(k) - llo) * ROW_W;
    const size_t row0 = static_cast<size_t>(start + llo) * ROW_W;
    for (int f = tid; f < nwords; f += PIX) {
      const int jj = f / ROW_W;
      const int c = f - jj * ROW_W;
      const unsigned wrote = s_wrote[b][jj];
      if (wrote == 0u) continue;  // no pixel blends this pair: its row stays zero
      auto sum = [&](int q) {     // the marked warps' partials of sum q, in warp order
        const float4 p0 = *reinterpret_cast<const float4*>(&s_part[jj][q * NWARP]);
        const float4 p1 = *reinterpret_cast<const float4*>(&s_part[jj][q * NWARP + 4]);
        const float p[NWARP] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w)
          if (wrote & (1u << w)) acc += p[w];
        return acc;
      };
      // gradient g of the pair; one explicit fma in the means, so every
      // output mode rounds the same float32 value
      auto grad = [&](int g) {
        const float4 gm = geom[jj];  // mean x, mean y, conic a, conic b
        if (g == 5) return sum(0) / fmaxf(col[jj].w, 1e-12f);  // opacity
        if (g < 2) {  // mean x, mean y
          const float s1 = sum(1), s2 = sum(2);
          return g == 0 ? fmaf(gm.z, s1, gm.w * s2) : fmaf(row1[jj].x, s2, gm.w * s1);
        }
        // conic a, b, c: -S_dxdx / 2, -S_dxdy, -S_dydy / 2; r, g, b
        const float s = sum(g < 5 ? g + 1 : g);
        return (g == 2 || g == 4) ? -0.5f * s : (g == 3 ? -s : s);
      };
      if constexpr (kOut == OUT_F32) {
        static_cast<float*>(pair_grads)[row0 + f] = grad(c);
      } else {
        const uint32_t hi = bf16_bits<kOut>(grad(2 * c));
        const uint32_t lo = 2 * c + 1 < NSUM ? bf16_bits<kOut>(grad(2 * c + 1)) : 0u;
        static_cast<uint32_t*>(pair_grads)[row0 + f] = (hi << 16) | (lo & 0xFFFFu);
      }
    }
    decode(k + 1);
  }
  if (kCount) counts[o] = n_live;
}

template <bool kCull, bool kCount, int kOut>
void launch(const void* tile_start, const void* pair_gauss, const void* gauss_attrs,
            const void* d_colors, const void* d_T, const void* final_T, const void* n_contrib,
            void* pair_grads, void* counts, int num_tiles, int tiles_x, void* stream) {
  if (num_tiles <= 0) return;
  composite_bwd_kernel<kCull, kCount, kOut>
      <<<num_tiles, PIX, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(tile_start), static_cast<const int32_t*>(pair_gauss),
          static_cast<const float4*>(gauss_attrs), static_cast<const float*>(d_colors),
          static_cast<const float*>(d_T), static_cast<const float*>(final_T),
          static_cast<const int32_t*>(n_contrib), pair_grads,
          static_cast<int32_t*>(counts), tiles_x);
}

using Launch = void (*)(const void*, const void*, const void*, const void*, const void*,
                        const void*, const void*, void*, void*, int, int, void*);

// the instance of (cull, count) for output mode `out`, or null
template <bool kCull, bool kCount>
Launch instance(int out) {
  switch (out) {
    case OUT_F32: return launch<kCull, kCount, OUT_F32>;
    case OUT_BF16_UP: return launch<kCull, kCount, OUT_BF16_UP>;
    case OUT_BF16_EVEN: return launch<kCull, kCount, OUT_BF16_EVEN>;
    default: return nullptr;
  }
}

}  // namespace

// The training instance. out_mode: 0 (P, 9) float32, 1 (P, 5) int32 of
// bf16 pairs rounded half up, 2 the same rounded to nearest even.
extern "C" int gsjax_composite_bwd(const void* tile_start, const void* pair_gauss,
                                   const void* gauss_attrs, const void* d_colors,
                                   const void* d_T, const void* final_T,
                                   const void* n_contrib, void* pair_grads, int num_tiles,
                                   int tiles_x, int out_mode, void* stream) {
  const Launch fn = instance<true, false>(out_mode);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn(tile_start, pair_gauss, gauss_attrs, d_colors, d_T, final_T, n_contrib, pair_grads,
     nullptr, num_tiles, tiles_x, stream);
  return static_cast<int>(cudaGetLastError());
}

// The check instances: the training instance (cull 1) or the same without
// the per-warp cull (cull 0), each also writing every pixel's count of
// contributing pairs into `counts` (T, 256) int32; out_mode as above.
extern "C" int gsjax_composite_bwd_counts(const void* tile_start, const void* pair_gauss,
                                          const void* gauss_attrs, const void* d_colors,
                                          const void* d_T, const void* final_T,
                                          const void* n_contrib, void* pair_grads,
                                          void* counts, int num_tiles, int tiles_x, int cull,
                                          int out_mode, void* stream) {
  const Launch fn = cull ? instance<true, true>(out_mode) : instance<false, true>(out_mode);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  fn(tile_start, pair_gauss, gauss_attrs, d_colors, d_T, final_T, n_contrib, pair_grads,
     counts, num_tiles, tiles_x, stream);
  return static_cast<int>(cudaGetLastError());
}
