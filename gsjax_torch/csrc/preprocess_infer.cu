// Primal preprocess kernel for Hopper (sm_90a): everything
// ops/projection.py:preprocess returns, one thread a gaussian slot.
//
// It replaces no Pallas kernel. gsjax's preprocess (gsjax/ops/projection.py)
// is jnp code that XLA fuses into a few loops on the TPU. Eager PyTorch, even
// replayed as a CUDA graph, runs it as about a hundred separate kernels over
// the slot axis (column stacks, a batched 16x3 GEMV for the SH color, strided
// elementwise ops), each writing its result to HBM for the next to read: 19.6
// ms of a 3M-gaussian 1080p frame's 33 ms on an H100, against ~0.4 ms of
// bytes. This
// kernel is that fusion, for the no-gradient path only (preprocess_infer in
// ops/projection.py); under autograd the port keeps the plain version, which
// stays the definition.
//
// Semantics (projection.py:preprocess_plain, gsjax's operation order): the
// projection (view z, pixel position), the 3D covariance from scale,
// quaternion and scale_modifier (or cov3d_precomp), EWA with the 1.3 tan-fov
// clamp and the +0.3 low-pass, det, conic, lambda1 and the 3-sigma radius,
// the near-plane (z > 0.2), det > 0 and active cull, the plain 3-sigma tile
// rectangle (for radii) and the opacity-aware binning rectangle with
// tiles_touched, the SH color over the coefficients up to sh_degree with +0.5
// and the clamp at 0 (or colors_precomp), and the f16 quantization of colors
// and opacities (round to nearest, |q| < 2^-14 flushed to +0).
//
// Precision. IEEE float32 division, sqrtf, logf and rsqrtf (what PyTorch's
// rsqrt runs), no --use_fast_math. Built with -fmad=false: PyTorch runs each
// multiply and add of the plain version as its own kernel, so nothing may
// contract here either. The exceptions are the plain version's library
// steps, reproduced in their order as measured on an H100 (PyTorch 2.11,
// CUDA 12.8): cuBLAS's (N, 4) @ (4, 4) products accumulate x*m0, then
// fma(y, m1), fma(z, m2), + m3; and torch.sum over a row of 4 (3) squares adds
// (s0 + s2) + (s1 + s3) ((s0 + s2) + s1); the SH sum (a batched GEMV) adds two
// halves of 8 coefficients, each accumulated in order. With those, every
// field equals the plain version's on the card bit for bit at K = 16 (the
// port's SH rows), so radii, rectangles and tiles_touched (which pick the
// pairs) are equal; with fewer coefficients a row the GEMV may split the sum
// elsewhere, and the colors can differ by an f16 step. -fmad=false costs a
// few instructions a slot, which the memory-bound kernel hides: on an H100
// (700 W) it takes 0.107 ms at 2^20 slots and 0.363 ms at 2^22 (the
// benchmark's view scenes), 1.28x and 1.24x the bytes those slots need at
// 3.35 TB/s.
//
// Slots with radii == 0 feed no pair (tiles_touched is 0 there too): their SH
// row is never read and their colors are written as 0. Their other fields are
// the plain version's.
//
// Bytes: a slot reads xyz, scale, quaternion (one 16-byte load when aligned),
// opacity and its active byte (45 B), and only for slots with radii > 0 its
// first min(K, (sh_degree + 1)^2) SH coefficients as float4 loads (a 192-byte
// row at K = 16); it writes 64 B, each field once. No shared memory, no
// allocation, no synchronisation: the launch is captured in the frame's CUDA
// graph.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr float TILE = 16.0f;
// projection.py's scalars, rounded from double as PyTorch rounds a Python
// float scalar
constexpr float NEAR_CULL_Z = static_cast<float>(0.2);
constexpr float LOW_PASS = static_cast<float>(0.3);
constexpr float MIN_LAMBDA = static_cast<float>(0.1);
constexpr float TAN_CLAMP = static_cast<float>(1.3);
constexpr float W_EPS = static_cast<float>(1e-7);
constexpr float Z_EPS = static_cast<float>(1e-6);
constexpr float OP_EPS = static_cast<float>(1e-12);
constexpr float NORM_EPS2 = static_cast<float>(1e-12 * 1e-12);  // safe_normalize's eps ** 2

// the SH constants of utils/sh.py, rounded alike
constexpr float C0 = static_cast<float>(0.28209479177387814);
constexpr float C1 = static_cast<float>(0.4886025119029199);
constexpr float C2_0 = static_cast<float>(1.0925484305920792);
constexpr float C2_1 = static_cast<float>(-1.0925484305920792);
constexpr float C2_2 = static_cast<float>(0.31539156525252005);
constexpr float C2_3 = static_cast<float>(-1.0925484305920792);
constexpr float C2_4 = static_cast<float>(0.5462742152960396);
constexpr float C3_0 = static_cast<float>(-0.5900435899266435);
constexpr float C3_1 = static_cast<float>(2.890611442640554);
constexpr float C3_2 = static_cast<float>(-0.4570457994644658);
constexpr float C3_3 = static_cast<float>(0.3731763325901154);
constexpr float C3_4 = static_cast<float>(-0.4570457994644658);
constexpr float C3_5 = static_cast<float>(1.445305721320277);
constexpr float C3_6 = static_cast<float>(-0.5900435899266435);
constexpr float NEG_C1 = static_cast<float>(-0.4886025119029199);

struct Args {
  // inputs; cov3d, colors_pre, active and offset may be null
  const float* means3d;     // (N, 3)
  const float* scales;      // (N, 3)
  const float* quats;       // (N, 4)
  const float* opacities;   // (N,)
  const float* shs;         // (N, K, 3)
  const float* cov3d;       // (N, 6)
  const float* colors_pre;  // (N, 3)
  const uint8_t* active;    // (N,) bool
  const float* offset;      // (N, 2)
  const float* world_view;  // (4, 4)
  const float* full_proj;   // (4, 4)
  const float* center;      // (3,)
  const float* tan_fov_x;   // ()
  const float* tan_fov_y;   // ()
  // outputs
  float* means2d;        // (N, 2)
  float* depths;         // (N,)
  float* conics;         // (N, 3)
  float* colors;         // (N, 3)
  float* opac_out;       // (N,)
  int32_t* radii;        // (N,)
  int32_t* rect_min;     // (N, 2)
  int32_t* rect_max;     // (N, 2)
  int32_t* tiles;        // (N,)
  int n;
  int k;                 // SH coefficients a row holds
  int k_used;            // min(k, (sh_degree + 1)^2)
  int width, height;
  float scale_modifier;
  int opacity_aware;
};

// PyTorch's clamp / clamp_min / minimum on float32: a NaN input passes through
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float t_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// quantize_f16: nearest f16, |q| < 2^-14 flushed to +0
__device__ __forceinline__ float quantize_f16(float x) {
  const float q = __half2float(__float2half_rn(x));
  return fabsf(q) < 6.103515625e-05f ? 0.0f : q;
}

// row . (x, y, z, 1) in cuBLAS's order for hom @ M.T
__device__ __forceinline__ float hom_dot(const float* row, float x, float y, float z) {
  float acc = x * __ldg(row);
  acc = __fmaf_rn(y, __ldg(row + 1), acc);
  acc = __fmaf_rn(z, __ldg(row + 2), acc);
  return acc + __ldg(row + 3);
}

// torch.clamp(floor(v / 16), 0, tiles).to(int32); float -> int truncates
// (a NaN converts to 0) as PyTorch's cast does
__device__ __forceinline__ int tile_of(float v, int tiles) {
  return static_cast<int>(t_clamp(floorf(v / TILE), 0.0f, static_cast<float>(tiles)));
}

struct Rect {
  int x0, y0, x1, y1;
  __device__ __forceinline__ int touched() const { return (x1 - x0) * (y1 - y0); }
};

// projection.py's rects_of(r)
__device__ __forceinline__ Rect rect_of(float px, float py, float r, int tiles_x,
                                        int tiles_y) {
  Rect q;
  q.x0 = tile_of(px - r, tiles_x);
  q.y0 = tile_of(py - r, tiles_y);
  q.x1 = tile_of(((px + r) + TILE) - 1.0f, tiles_x);
  q.y1 = tile_of(((py + r) + TILE) - 1.0f, tiles_y);
  return q;
}

// eval_sh over the first k_used coefficients of a row, dirs (x, y, z) unit
__device__ __forceinline__ void sh_color(const Args& a, int64_t i, float x, float y, float z,
                                         float rgb[3]) {
  const int nf = a.k_used * 3;
  float c[48];
  const float* row = a.shs + i * a.k * 3;
  if ((a.k & 3) == 0 && (reinterpret_cast<uintptr_t>(a.shs) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      if (4 * j < nf) {
        const float4 v = __ldg(row4 + j);
        c[4 * j] = v.x;
        c[4 * j + 1] = v.y;
        c[4 * j + 2] = v.z;
        c[4 * j + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 48; ++j) {
      if (j < nf) c[j] = __ldg(row + j);
    }
  }
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  const float b[16] = {
      C0 * 1.0f,
      NEG_C1 * y,
      C1 * z,
      NEG_C1 * x,
      C2_0 * xy,
      C2_1 * yz,
      C2_2 * (((2.0f * zz) - xx) - yy),
      C2_3 * xz,
      C2_4 * (xx - yy),
      (C3_0 * y) * ((3.0f * xx) - yy),
      (C3_1 * xy) * z,
      (C3_2 * y) * (((4.0f * zz) - xx) - yy),
      (C3_3 * z) * (((2.0f * zz) - (3.0f * xx)) - (3.0f * yy)),
      (C3_4 * x) * (((4.0f * zz) - xx) - yy),
      (C3_5 * z) * (xx - yy),
      (C3_6 * x) * (xx - (3.0f * yy)),
  };
  // cuBLAS's batched GEMV order at K = 16: coefficients 0-7 and 8-15 each
  // accumulate in order (the first a product, then fused), then the halves add
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float lo = b[0] * c[ch], hi = 0.0f;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      if (j < a.k_used) lo = __fmaf_rn(b[j], c[3 * j + ch], lo);
    }
    if (a.k_used > 8) {
      hi = b[8] * c[24 + ch];
#pragma unroll
      for (int j = 9; j < 16; ++j) {
        if (j < a.k_used) hi = __fmaf_rn(b[j], c[3 * j + ch], hi);
      }
    }
    rgb[ch] = a.k_used > 0 ? lo + hi : 0.0f;
  }
}

__global__ void __launch_bounds__(BLOCK) preprocess_infer_kernel(const Args a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= a.n) return;
  const int tiles_x = (a.width + 15) / 16, tiles_y = (a.height + 15) / 16;

  // camera scalars, as the plain version derives them from the 0-d tensors
  const float tan_x = __ldg(a.tan_fov_x), tan_y = __ldg(a.tan_fov_y);
  const float focal_x = (1.0f / (2.0f * tan_x)) * static_cast<float>(a.width);
  const float focal_y = (1.0f / (2.0f * tan_y)) * static_cast<float>(a.height);
  const float lim_x = TAN_CLAMP * tan_x, lim_y = TAN_CLAMP * tan_y;

  // ---- projection: view z and the pixel position ----------------------------
  const float mx = __ldg(a.means3d + 3 * i), my = __ldg(a.means3d + 3 * i + 1),
              mz = __ldg(a.means3d + 3 * i + 2);
  const float* wv = a.world_view;
  const float t0 = hom_dot(wv, mx, my, mz), t1 = hom_dot(wv + 4, mx, my, mz);
  const float depth = hom_dot(wv + 8, mx, my, mz);
  const float* fp = a.full_proj;
  const float h0 = hom_dot(fp, mx, my, mz), h1 = hom_dot(fp + 4, mx, my, mz);
  const float p_w = 1.0f / (hom_dot(fp + 12, mx, my, mz) + W_EPS);
  float px = (((h0 * p_w) + 1.0f) * static_cast<float>(a.width) - 1.0f) * 0.5f;
  float py = (((h1 * p_w) + 1.0f) * static_cast<float>(a.height) - 1.0f) * 0.5f;
  if (a.offset != nullptr) {
    px = px + __ldg(a.offset + 2 * i);
    py = py + __ldg(a.offset + 2 * i + 1);
  }

  const float op = quantize_f16(__ldg(a.opacities + i));

  // ---- 3D covariance [xx, xy, xz, yy, yz, zz] ------------------------------
  float sxx, sxy, sxz, syy, syz, szz;
  if (a.cov3d != nullptr) {
    const float* cv = a.cov3d + 6 * i;
    sxx = __ldg(cv);
    sxy = __ldg(cv + 1);
    sxz = __ldg(cv + 2);
    syy = __ldg(cv + 3);
    syz = __ldg(cv + 4);
    szz = __ldg(cv + 5);
  } else {
    float4 q;
    if ((reinterpret_cast<uintptr_t>(a.quats) & 15) == 0) {
      q = __ldg(reinterpret_cast<const float4*>(a.quats) + i);
    } else {
      q = make_float4(__ldg(a.quats + 4 * i), __ldg(a.quats + 4 * i + 1),
                      __ldg(a.quats + 4 * i + 2), __ldg(a.quats + 4 * i + 3));
    }
    // safe_normalize: torch.sum's order over a row of 4, then rsqrt
    const float n2 = ((q.x * q.x) + (q.z * q.z)) + ((q.y * q.y) + (q.w * q.w));
    const float rn = rsqrtf(n2 + NORM_EPS2);
    const float w = q.x * rn, x = q.y * rn, y = q.z * rn, z = q.w * rn;
    const float r00 = 1.0f - 2.0f * ((y * y) + (z * z));
    const float r01 = 2.0f * ((x * y) - (w * z));
    const float r02 = 2.0f * ((x * z) + (w * y));
    const float r10 = 2.0f * ((x * y) + (w * z));
    const float r11 = 1.0f - 2.0f * ((x * x) + (z * z));
    const float r12 = 2.0f * ((y * z) - (w * x));
    const float r20 = 2.0f * ((x * z) - (w * y));
    const float r21 = 2.0f * ((y * z) + (w * x));
    const float r22 = 1.0f - 2.0f * ((x * x) + (y * y));
    const float s0 = __ldg(a.scales + 3 * i) * a.scale_modifier;
    const float s1 = __ldg(a.scales + 3 * i + 1) * a.scale_modifier;
    const float s2 = __ldg(a.scales + 3 * i + 2) * a.scale_modifier;
    const float u0 = s0 * s0, u1 = s1 * s1, u2 = s2 * s2;
    sxx = ((r00 * r00) * u0 + (r01 * r01) * u1) + (r02 * r02) * u2;
    sxy = ((r00 * r10) * u0 + (r01 * r11) * u1) + (r02 * r12) * u2;
    sxz = ((r00 * r20) * u0 + (r01 * r21) * u1) + (r02 * r22) * u2;
    syy = ((r10 * r10) * u0 + (r11 * r11) * u1) + (r12 * r12) * u2;
    syz = ((r10 * r20) * u0 + (r11 * r21) * u1) + (r12 * r22) * u2;
    szz = ((r20 * r20) * u0 + (r21 * r21) * u1) + (r22 * r22) * u2;
  }

  // ---- EWA: the 2D covariance with the low-pass -----------------------------
  float tz = depth;
  if (fabsf(tz) < Z_EPS) tz = Z_EPS;
  const float tx = t_clamp(t0 / tz, -lim_x, lim_x) * tz;
  const float ty = t_clamp(t1 / tz, -lim_y, lim_y) * tz;
  const float inv_z = 1.0f / tz;
  const float ja = focal_x * inv_z, jb = focal_y * inv_z;
  const float jc = (((-focal_x) * tx) * inv_z) * inv_z;
  const float jd = (((-focal_y) * ty) * inv_z) * inv_z;
  float m0[3], m1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m0[k] = ja * __ldg(wv + k) + jc * __ldg(wv + 8 + k);
    m1[k] = jb * __ldg(wv + 4 + k) + jd * __ldg(wv + 8 + k);
  }
  const float s00 = (sxx * m0[0] + sxy * m0[1]) + sxz * m0[2];
  const float s01 = (sxy * m0[0] + syy * m0[1]) + syz * m0[2];
  const float s02 = (sxz * m0[0] + syz * m0[1]) + szz * m0[2];
  const float s10 = (sxx * m1[0] + sxy * m1[1]) + sxz * m1[2];
  const float s11 = (sxy * m1[0] + syy * m1[1]) + syz * m1[2];
  const float s12 = (sxz * m1[0] + syz * m1[1]) + szz * m1[2];
  const float c00 = ((m0[0] * s00 + m0[1] * s01) + m0[2] * s02) + LOW_PASS;
  const float c01 = (m0[0] * s10 + m0[1] * s11) + m0[2] * s12;
  const float c11 = ((m1[0] * s10 + m1[1] * s11) + m1[2] * s12) + LOW_PASS;

  // ---- conic, lambda1, radius and the cull ----------------------------------
  const float det = c00 * c11 - c01 * c01;
  const bool det_ok = det > 0.0f;
  const float safe_det = det_ok ? det : 1.0f;
  const float mid = 0.5f * (c00 + c11);
  const float lambda1 = mid + sqrtf(t_clamp_min(mid * mid - det, MIN_LAMBDA));
  const float radius = ceilf(3.0f * sqrtf(lambda1));

  bool valid = depth > NEAR_CULL_Z && det_ok;
  if (a.active != nullptr) valid = valid && a.active[i] != 0;
  const Rect plain = rect_of(px, py, radius, tiles_x, tiles_y);
  valid = valid && plain.touched() > 0;

  Rect bin = plain;
  int tiles;
  if (a.opacity_aware) {
    const float chi = 2.0f * logf(255.0f * t_clamp_min(op, OP_EPS));
    const float r_bin = t_minimum(
        radius, ceilf(sqrtf(t_clamp_min(chi, 0.0f) * lambda1)) + 1.0f);
    bin = rect_of(px, py, r_bin, tiles_x, tiles_y);
    tiles = valid && chi > 0.0f ? bin.touched() : 0;
  } else {
    tiles = valid ? plain.touched() : 0;
  }

  // ---- color: SH only for slots that feed pairs -----------------------------
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (a.colors_pre != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = quantize_f16(__ldg(a.colors_pre + 3 * i + ch));
  } else if (valid) {
    const float* cc = a.center;
    const float vx = mx - __ldg(cc), vy = my - __ldg(cc + 1), vz = mz - __ldg(cc + 2);
    // safe_normalize: torch.sum's order over a row of 3
    const float rn = rsqrtf((((vx * vx) + (vz * vz)) + (vy * vy)) + NORM_EPS2);
    sh_color(a, i, vx * rn, vy * rn, vz * rn, rgb);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = quantize_f16(t_clamp_min(rgb[ch] + 0.5f, 0.0f));
  }

  // ---- write each field once --------------------------------------------------
  reinterpret_cast<float2*>(a.means2d)[i] = make_float2(px, py);
  a.depths[i] = depth;
  a.conics[3 * i] = c11 / safe_det;
  a.conics[3 * i + 1] = (-c01) / safe_det;
  a.conics[3 * i + 2] = c00 / safe_det;
  a.colors[3 * i] = rgb[0];
  a.colors[3 * i + 1] = rgb[1];
  a.colors[3 * i + 2] = rgb[2];
  a.opac_out[i] = op;
  a.radii[i] = valid ? static_cast<int32_t>(radius) : 0;
  reinterpret_cast<int2*>(a.rect_min)[i] = make_int2(bin.x0, bin.y0);
  reinterpret_cast<int2*>(a.rect_max)[i] = make_int2(bin.x1, bin.y1);
  a.tiles[i] = tiles;
}

}  // namespace

extern "C" int gsjax_preprocess_infer(
    const void* means3d, const void* scales, const void* quats, const void* opacities,
    const void* shs, const void* cov3d, const void* colors_pre, const void* active,
    const void* offset, const void* world_view, const void* full_proj, const void* center,
    const void* tan_fov_x, const void* tan_fov_y, void* means2d, void* depths, void* conics,
    void* colors, void* opac_out, void* radii, void* rect_min, void* rect_max, void* tiles,
    int n, int k, int k_used, int width, int height, float scale_modifier, int opacity_aware,
    void* stream) {
  if (n > 0) {
    Args a;
    a.means3d = static_cast<const float*>(means3d);
    a.scales = static_cast<const float*>(scales);
    a.quats = static_cast<const float*>(quats);
    a.opacities = static_cast<const float*>(opacities);
    a.shs = static_cast<const float*>(shs);
    a.cov3d = static_cast<const float*>(cov3d);
    a.colors_pre = static_cast<const float*>(colors_pre);
    a.active = static_cast<const uint8_t*>(active);
    a.offset = static_cast<const float*>(offset);
    a.world_view = static_cast<const float*>(world_view);
    a.full_proj = static_cast<const float*>(full_proj);
    a.center = static_cast<const float*>(center);
    a.tan_fov_x = static_cast<const float*>(tan_fov_x);
    a.tan_fov_y = static_cast<const float*>(tan_fov_y);
    a.means2d = static_cast<float*>(means2d);
    a.depths = static_cast<float*>(depths);
    a.conics = static_cast<float*>(conics);
    a.colors = static_cast<float*>(colors);
    a.opac_out = static_cast<float*>(opac_out);
    a.radii = static_cast<int32_t*>(radii);
    a.rect_min = static_cast<int32_t*>(rect_min);
    a.rect_max = static_cast<int32_t*>(rect_max);
    a.tiles = static_cast<int32_t*>(tiles);
    a.n = n;
    a.k = k;
    a.k_used = k_used;
    a.width = width;
    a.height = height;
    a.scale_modifier = scale_modifier;
    a.opacity_aware = opacity_aware;
    preprocess_infer_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
