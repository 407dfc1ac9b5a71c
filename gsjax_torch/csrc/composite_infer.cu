// Inference compositing kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gsjax/ops/pallas_composite.py:
// _composite_infer_kernel (the primal-only render path: render.py, the
// viewer, the forward bench). The blend, its design and what bounds it are
// described in composite_blend.cuh; this instance records no n_contrib.

#include "composite_blend.cuh"

extern "C" int gsjax_composite_infer(const void* tile_start, const void* pair_gauss,
                                     const void* gauss_attrs, void* tile_colors,
                                     void* tile_T, int num_tiles, int tiles_x,
                                     void* stream) {
  if (num_tiles > 0) {
    gsjax::composite_blend_kernel<false, true>
        <<<num_tiles, gsjax::PIX, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int32_t*>(tile_start), static_cast<const int32_t*>(pair_gauss),
            static_cast<const float4*>(gauss_attrs), static_cast<float*>(tile_colors),
            static_cast<float*>(tile_T), nullptr, tiles_x);
  }
  return static_cast<int>(cudaGetLastError());
}
