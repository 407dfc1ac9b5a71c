// Training forward compositing kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gsjax/ops/pallas_composite.py:
// _composite_kernel (the forward of the differentiable compositor, called
// from _composite_vjp_fwd). The same blend as composite_infer (one
// template, composite_blend.cuh, so colors and T agree bit for bit) plus
// n_contrib (T, 256) int32, the local index + 1 of the last pair each
// pixel blended. The TPU kernel passes that count through a float row and
// rounds it (pallas_composite.py:746-750); here it is an exact int32.
//
// Bound: as composite_infer — operations (the walk its per-warp cull
// leaves, and the blends); the extra output adds 8 KB of writes per 1,000
// tiles.
//
// gsjax_composite_fwd launches the training instance. gsjax_composite_fwd_
// check launches the check instance, never on the render or training
// path: the same walk without the per-warp cull. The two must agree bit
// for bit: the cull, on the card's own arithmetic, lost nothing.

#include "composite_blend.cuh"

namespace {

template <bool kCull>
void launch(const void* tile_start, const void* pair_gauss, const void* gauss_attrs,
            void* tile_colors, void* tile_T, void* n_contrib, int num_tiles, int tiles_x,
            void* stream) {
  if (num_tiles <= 0) return;
  gsjax::composite_blend_kernel<true, kCull>
      <<<num_tiles, gsjax::PIX, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(tile_start), static_cast<const int32_t*>(pair_gauss),
          static_cast<const float4*>(gauss_attrs), static_cast<float*>(tile_colors),
          static_cast<float*>(tile_T), static_cast<int32_t*>(n_contrib), tiles_x);
}

}  // namespace

extern "C" int gsjax_composite_fwd(const void* tile_start, const void* pair_gauss,
                                   const void* gauss_attrs, void* tile_colors,
                                   void* tile_T, void* n_contrib, int num_tiles,
                                   int tiles_x, void* stream) {
  launch<true>(tile_start, pair_gauss, gauss_attrs, tile_colors, tile_T, n_contrib, num_tiles,
               tiles_x, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsjax_composite_fwd_check(const void* tile_start, const void* pair_gauss,
                                         const void* gauss_attrs, void* tile_colors,
                                         void* tile_T, void* n_contrib, int num_tiles,
                                         int tiles_x, void* stream) {
  launch<false>(tile_start, pair_gauss, gauss_attrs, tile_colors, tile_T, n_contrib, num_tiles,
                tiles_x, stream);
  return static_cast<int>(cudaGetLastError());
}
