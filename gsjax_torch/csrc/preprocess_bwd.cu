// Backward of the preprocess for Hopper (sm_90a): the gradients of
// ops/projection.py:preprocess_plain's inputs from those of its outputs, one
// thread a gaussian slot.
//
// It replaces no Pallas kernel. gsjax differentiates its jnp preprocess
// (gsjax/ops/projection.py) through XLA, which fuses the backward into a few
// loops on the TPU. PyTorch's autograd replays the plain version's ~100 tensor
// ops over the slot axis backwards, one or more kernels each, every one
// writing a full-size result to HBM for the next to read: 31 ms of a
// 3M-gaussian training step's 93 ms on an H100. This kernel is that backward
// in one pass (ops/projection.py:preprocess_bwd, launched by the backward of
// preprocess_train's autograd.Function); the forward stays the plain version.
// ops/projection.py:preprocess_vjp_plain is the same closed form in tensor
// ops, term by term.
//
// Semantics: autograd over preprocess_plain (default path: no precomputed
// covariance or colors), from the gradients of means2d (N, 2), conics (N, 3),
// colors (N, 3) and opacities (N,) to those of means3d, scales, quats,
// opacities, shs (N, K, 3) and the means2d offset (N, 2). Depths, radii, the
// rectangles and tiles_touched carry no gradient. Term by term:
// - quantize_f16's straight-through: the incoming gradient of colors and
//   opacities is rounded to float16 (round to nearest even, as PyTorch's
//   .to(float16) of the gradient) and zeroed where the forward's value was
//   flushed (|q| < 2^-14);
// - the colors' clamp at 0 passes the gradient where raw + 0.5 >= 0;
// - SH coefficients of bands above sh_degree (and beyond K) get zero, the
//   basis' derivative in the view direction flows through
//   safe_normalize(means3d - camera_center);
// - the projection: ndc = p_hom[:2] / (p_hom[3] + 1e-7) to pixels; the
//   offset's gradient is means2d's;
// - the conic's inverse, through det where det > 0;
// - EWA: the 1.3 tan-fov clamp passes only the tz factor where it clamps,
//   |tz| < 1e-6 blocks tz's gradient; J W Sigma W^T J^T's chain to Sigma and
//   the view-space mean;
// - covariance6: Sigma = R diag(s m)^2 R^T through the quaternion's
//   safe_normalize.
// A slot whose four incoming gradients are all zero (every slot without a
// pair) writes zero gradients and reads nothing else: what autograd gives
// there, 0 x finite.
//
// Precision: float32 throughout, IEEE division, sqrt and rsqrt, no
// --use_fast_math. The forward quantities the masks read (the f16 flushes,
// the clamps, det > 0) are recomputed in the plain version's order (hom_dot's
// cuBLAS order, the SH sum's two halves, as csrc/preprocess_infer.cu), so they
// agree with it except a value on a mask's edge. The gradients' sums run in
// this kernel's order, not autograd's, and the conic's step is -K G K (K the
// conic), where autograd subtracts adj(C) / det's two terms: on the bench
// scene on an H100 each gradient's norm of the difference from autograd over
// preprocess_plain is under 1e-6 of its norm (tests/test_torch_cuda.py's
// BWD_TOL states the per-element tolerance and why). Built without
// -fmad=false.
//
// Bytes: a slot reads its 9 incoming gradients (36 B; rows of any stride: the
// reduction's (N, 9) table is read in place), and, where they are not all
// zero, xyz, scale and quaternion (one 16-byte load) and opacity (32 B) and,
// only where the color gradient is not zero, the first min(K, (sh_degree +
// 1)^2) SH coefficients (float4 loads, up to 192 B); it writes 61 floats (244
// B). ~520 B a slot at most: 0.65 ms at 2^22 slots at 3.35 TB/s.
//
// Design: the (N, K, 3) SH gradient is 79% of the bytes. Each thread stages
// its row in shared memory (float4 stores, a stride of 52 floats so a quarter
// warp's stores hit distinct banks), then each warp writes its 32 rows as one
// contiguous run (6 KB at K = 16) with float4 stores whose lanes cover
// neighbouring addresses. The other outputs are a few words a slot. No
// allocation, no synchronisation beyond __syncwarp: the launch is captured in
// the training step's CUDA graph.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int SH_MAX = 48;     // floats of a 16-coefficient SH row
constexpr int SH_STRIDE = 52;  // a staged row's stride in shared memory
// projection.py's scalars, rounded from double as PyTorch rounds a Python
// float scalar
constexpr float W_EPS = static_cast<float>(1e-7);
constexpr float Z_EPS = static_cast<float>(1e-6);
constexpr float TAN_CLAMP = static_cast<float>(1.3);
constexpr float NORM_EPS2 = static_cast<float>(1e-12 * 1e-12);  // safe_normalize's eps ** 2
constexpr float F16_MIN_NORMAL = 6.103515625e-05f;               // 2^-14

// the SH constants of utils/sh.py, rounded alike
constexpr float C0 = static_cast<float>(0.28209479177387814);
constexpr float C1 = static_cast<float>(0.4886025119029199);
constexpr float NEG_C1 = static_cast<float>(-0.4886025119029199);
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

struct Args {
  // the forward's inputs (post-activation) and camera
  const float* means3d;     // (N, 3)
  const float* scales;      // (N, 3)
  const float* quats;       // (N, 4)
  const float* opacities;   // (N,)
  const float* shs;         // (N, K, 3)
  const float* world_view;  // (4, 4)
  const float* full_proj;   // (4, 4)
  const float* center;      // (3,)
  const float* tan_fov_x;   // ()
  const float* tan_fov_y;   // ()
  // incoming gradients, rows `stride` floats apart; null is a zero gradient
  const float* g_means2d;  // (N, 2)
  const float* g_conics;   // (N, 3)
  const float* g_colors;   // (N, 3)
  const float* g_opac;     // (N,)
  int s_means2d, s_conics, s_colors, s_opac;
  // outputs, contiguous; d_offset may be null (not written)
  float* d_means3d;  // (N, 3)
  float* d_scales;   // (N, 3)
  float* d_quats;    // (N, 4)
  float* d_opac;     // (N,)
  float* d_shs;      // (N, K, 3)
  float* d_offset;   // (N, 2)
  int n;
  int k;       // SH coefficients a row holds
  int k_used;  // min(k, (sh_degree + 1)^2)
  int width, height;
  float scale_modifier;
};

// .to(float16).to(float32): nearest f16, subnormals kept, overflow to inf
__device__ __forceinline__ float f16_round(float x) { return __half2float(__float2half_rn(x)); }

// quantize_f16's flush: |f16(x)| < 2^-14
__device__ __forceinline__ bool f16_flushed(float x) { return fabsf(f16_round(x)) < F16_MIN_NORMAL; }

// row . (x, y, z, 1) in cuBLAS's order for hom @ M.T
__device__ __forceinline__ float hom_dot(const float* row, float x, float y, float z) {
  float acc = x * __ldg(row);
  acc = __fmaf_rn(y, __ldg(row + 1), acc);
  acc = __fmaf_rn(z, __ldg(row + 2), acc);
  return acc + __ldg(row + 3);
}

__device__ __forceinline__ float load_grad(const float* p, int64_t i, int stride, int j) {
  return p == nullptr ? 0.0f : __ldg(p + i * stride + j);
}

// The color's backward: stages the SH row's gradient in `stage` and adds the
// view direction's term to dm. g_col is the incoming gradient, not all zero.
__device__ __forceinline__ void color_bwd(const Args& a, int64_t i, float mx, float my, float mz,
                                          const float g_col[3], float* stage, float dm[3]) {
  const float vx = mx - __ldg(a.center), vy = my - __ldg(a.center + 1),
              vz = mz - __ldg(a.center + 2);
  const float rv = rsqrtf((((vx * vx) + (vz * vz)) + (vy * vy)) + NORM_EPS2);
  const float x = vx * rv, y = vy * rv, z = vz * rv;
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
  // the used coefficients of the row
  const int nf = a.k_used * 3;
  float c[SH_MAX];
  const float* row = a.shs + i * a.k * 3;
  if ((a.k & 3) == 0 && (reinterpret_cast<uintptr_t>(a.shs) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int j = 0; j < SH_MAX / 4; ++j) {
      const float4 v = 4 * j < nf ? __ldg(row4 + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      c[4 * j] = v.x;
      c[4 * j + 1] = v.y;
      c[4 * j + 2] = v.z;
      c[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < SH_MAX; ++j) c[j] = j < nf ? __ldg(row + j) : 0.0f;
  }
  // the forward color in the plain version's order (two halves of the GEMV),
  // for the clamp's and the flush's masks
  float g_raw[3];
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
    const float col = (a.k_used > 0 ? lo + hi : 0.0f) + 0.5f;
    // clamp_min(col, 0) passes where col >= 0; quantize_f16 zeroes flushed values
    const bool pass = col >= 0.0f && !f16_flushed(fmaxf(col, 0.0f));
    g_raw[ch] = pass ? f16_round(g_col[ch]) : 0.0f;
  }
  // d shs[j][ch] = basis_j * g_raw[ch] for the used coefficients, else 0
#pragma unroll
  for (int v = 0; v < SH_MAX / 4; ++v) {
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int f = 4 * v + u;
      e[u] = f / 3 < a.k_used ? b[f / 3] * g_raw[f % 3] : 0.0f;
    }
    reinterpret_cast<float4*>(stage)[v] = make_float4(e[0], e[1], e[2], e[3]);
  }
  // d basis_j = sum over channels of shs[j][ch] * g_raw[ch] (zero above k_used)
  float gb[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    gb[j] = j < a.k_used ? (c[3 * j] * g_raw[0] + c[3 * j + 1] * g_raw[1]) + c[3 * j + 2] * g_raw[2]
                         : 0.0f;
  }
  // the basis' derivative in the direction (utils/sh.py:sh_basis)
  const float gx = -C1 * gb[3] + C2_0 * y * gb[4] - 2.0f * C2_2 * x * gb[6] + C2_3 * z * gb[7] +
                   2.0f * C2_4 * x * gb[8] + 6.0f * C3_0 * xy * gb[9] + C3_1 * yz * gb[10] -
                   2.0f * C3_2 * xy * gb[11] - 6.0f * C3_3 * xz * gb[12] +
                   C3_4 * (4.0f * zz - 3.0f * xx - yy) * gb[13] + 2.0f * C3_5 * xz * gb[14] +
                   3.0f * C3_6 * (xx - yy) * gb[15];
  const float gy = -C1 * gb[1] + C2_0 * x * gb[4] + C2_1 * z * gb[5] - 2.0f * C2_2 * y * gb[6] -
                   2.0f * C2_4 * y * gb[8] + 3.0f * C3_0 * (xx - yy) * gb[9] + C3_1 * xz * gb[10] +
                   C3_2 * (4.0f * zz - xx - 3.0f * yy) * gb[11] - 6.0f * C3_3 * yz * gb[12] -
                   2.0f * C3_4 * xy * gb[13] - 2.0f * C3_5 * yz * gb[14] -
                   6.0f * C3_6 * xy * gb[15];
  const float gz = C1 * gb[2] + C2_1 * y * gb[5] + 4.0f * C2_2 * z * gb[6] + C2_3 * x * gb[7] +
                   C3_1 * xy * gb[10] + 8.0f * C3_2 * yz * gb[11] +
                   C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] + 8.0f * C3_4 * xz * gb[13] +
                   C3_5 * (xx - yy) * gb[14];
  // through safe_normalize(v): d v = g rv - v rv^3 (g . v)
  const float g_n2 = -0.5f * (rv * rv * rv) * ((gx * vx + gy * vy) + gz * vz);
  dm[0] += gx * rv + 2.0f * vx * g_n2;
  dm[1] += gy * rv + 2.0f * vy * g_n2;
  dm[2] += gz * rv + 2.0f * vz * g_n2;
}

// The conic's backward through EWA and covariance6: adds the view-space
// mean's term to dm and writes d scale and d quat. g_con is not all zero.
__device__ __forceinline__ void conic_bwd(const Args& a, int64_t i, float mx, float my, float mz,
                                          const float g_con[3], float dm[3], float ds[3],
                                          float dq[4]) {
  const float* wv = a.world_view;
  const float tan_x = __ldg(a.tan_fov_x), tan_y = __ldg(a.tan_fov_y);
  // RenderCamera.focal_x: width / (2 tan), as PyTorch computes an int over a tensor
  const float fx = (1.0f / (2.0f * tan_x)) * static_cast<float>(a.width);
  const float fy = (1.0f / (2.0f * tan_y)) * static_cast<float>(a.height);
  const float lim_x = TAN_CLAMP * tan_x, lim_y = TAN_CLAMP * tan_y;

  // ---- covariance6 forward -------------------------------------------------
  float4 q;
  if ((reinterpret_cast<uintptr_t>(a.quats) & 15) == 0) {
    q = __ldg(reinterpret_cast<const float4*>(a.quats) + i);
  } else {
    q = make_float4(__ldg(a.quats + 4 * i), __ldg(a.quats + 4 * i + 1),
                    __ldg(a.quats + 4 * i + 2), __ldg(a.quats + 4 * i + 3));
  }
  const float n2q = ((q.x * q.x) + (q.z * q.z)) + ((q.y * q.y) + (q.w * q.w));
  const float rq = rsqrtf(n2q + NORM_EPS2);
  const float w = q.x * rq, x = q.y * rq, y = q.z * rq, z = q.w * rq;
  float R[3][3];
  R[0][0] = 1.0f - 2.0f * ((y * y) + (z * z));
  R[0][1] = 2.0f * ((x * y) - (w * z));
  R[0][2] = 2.0f * ((x * z) + (w * y));
  R[1][0] = 2.0f * ((x * y) + (w * z));
  R[1][1] = 1.0f - 2.0f * ((x * x) + (z * z));
  R[1][2] = 2.0f * ((y * z) - (w * x));
  R[2][0] = 2.0f * ((x * z) - (w * y));
  R[2][1] = 2.0f * ((y * z) + (w * x));
  R[2][2] = 1.0f - 2.0f * ((x * x) + (y * y));
  float sm[3], u[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sm[k] = __ldg(a.scales + 3 * i + k) * a.scale_modifier;
    u[k] = sm[k] * sm[k];
  }
  // Sigma[r][c] = sum_k R[r][k] R[c][k] u[k]
  float S[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int cc = r; cc < 3; ++cc) {
      S[r][cc] = ((R[r][0] * R[cc][0]) * u[0] + (R[r][1] * R[cc][1]) * u[1]) +
                 (R[r][2] * R[cc][2]) * u[2];
      S[cc][r] = S[r][cc];
    }
  }

  // ---- EWA forward ------------------------------------------------------------
  const float t0 = hom_dot(wv, mx, my, mz), t1 = hom_dot(wv + 4, mx, my, mz);
  const float t2 = hom_dot(wv + 8, mx, my, mz);
  const bool z_pass = !(fabsf(t2) < Z_EPS);
  const float tz = z_pass ? t2 : Z_EPS;
  const float ux = t0 / tz, uy = t1 / tz;
  const bool x_pass = ux >= -lim_x && ux <= lim_x;
  const bool y_pass = uy >= -lim_y && uy <= lim_y;
  const float cux = fminf(fmaxf(ux, -lim_x), lim_x), cuy = fminf(fmaxf(uy, -lim_y), lim_y);
  const float tx = cux * tz, ty = cuy * tz;
  const float inv_z = 1.0f / tz;
  const float ja = fx * inv_z, jb = fy * inv_z;
  const float ex = ((-fx) * tx) * inv_z, ey = ((-fy) * ty) * inv_z;
  const float jc = ex * inv_z, jd = ey * inv_z;
  float m0[3], m1[3], s0[3], s1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    m0[k] = ja * __ldg(wv + k) + jc * __ldg(wv + 8 + k);
    m1[k] = jb * __ldg(wv + 4 + k) + jd * __ldg(wv + 8 + k);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    s0[r] = (S[r][0] * m0[0] + S[r][1] * m0[1]) + S[r][2] * m0[2];
    s1[r] = (S[r][0] * m1[0] + S[r][1] * m1[1]) + S[r][2] * m1[2];
  }
  const float c00 = ((m0[0] * s0[0] + m0[1] * s0[1]) + m0[2] * s0[2]) + 0.3f;
  const float c01 = (m0[0] * s1[0] + m0[1] * s1[1]) + m0[2] * s1[2];
  const float c11 = ((m1[0] * s1[0] + m1[1] * s1[1]) + m1[2] * s1[2]) + 0.3f;

  // ---- the conic's inverse ----------------------------------------------------
  const float det = c00 * c11 - c01 * c01;
  const bool det_ok = det > 0.0f;
  const float sd = det_ok ? det : 1.0f;
  // where det > 0, d conic = -K dC K (K the conic as a symmetric 2x2 matrix):
  // d C = -K G K, G the conic's gradient as one (off-diagonal halved); it does
  // not cancel where the covariance is nearly axis-aligned, as adj(C) / det's
  // two terms do. Else conics = [c11, -c01, c00].
  float g00 = g_con[2], g01 = -g_con[1], g11 = g_con[0];
  if (det_ok) {
    const float ka = c11 / sd, kb = (-c01) / sd, kc = c00 / sd, h = 0.5f * g_con[1];
    const float kg0 = ka * g_con[0] + kb * h, kg1 = ka * h + kb * g_con[2];
    const float kg2 = kb * g_con[0] + kc * h, kg3 = kb * h + kc * g_con[2];
    g00 = -(ka * kg0 + kb * kg1);
    g01 = -2.0f * (kb * kg0 + kc * kg1);
    g11 = -(kb * kg2 + kc * kg3);
  }

  // ---- EWA backward -------------------------------------------------------------
  float gs0[3], gs1[3], gm0[3], gm1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gs0[k] = g00 * m0[k];
    gs1[k] = g01 * m0[k] + g11 * m1[k];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    gm0[r] = (g00 * s0[r] + g01 * s1[r]) +
             ((S[r][0] * gs0[0] + S[r][1] * gs0[1]) + S[r][2] * gs0[2]);
    gm1[r] = g11 * s1[r] + ((S[r][0] * gs1[0] + S[r][1] * gs1[1]) + S[r][2] * gs1[2]);
  }
  // d Sigma, symmetric: G[r][c] for the stripped entry (r, c), r <= c
  float G[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int cc = r; cc < 3; ++cc) {
      float g = gs0[r] * m0[cc] + gs1[r] * m1[cc];
      if (cc != r) g += gs0[cc] * m0[r] + gs1[cc] * m1[r];
      G[r][cc] = g;
      G[cc][r] = g;
    }
  }
  float g_a = 0.0f, g_b = 0.0f, g_c = 0.0f, g_d = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_a += gm0[k] * __ldg(wv + k);
    g_c += gm0[k] * __ldg(wv + 8 + k);
    g_b += gm1[k] * __ldg(wv + 4 + k);
    g_d += gm1[k] * __ldg(wv + 8 + k);
  }
  // c = ((-fx tx) inv_z) inv_z, d alike
  float g_inv = g_a * fx + g_b * fy + g_c * ex + (g_c * inv_z) * ((-fx) * tx) + g_d * ey +
                (g_d * inv_z) * ((-fy) * ty);
  const float g_tx = ((g_c * inv_z) * inv_z) * (-fx);
  const float g_ty = ((g_d * inv_z) * inv_z) * (-fy);
  float g_tz = -g_inv * (inv_z * inv_z) + g_tx * cux + g_ty * cuy;
  const float g_ux = x_pass ? g_tx * tz : 0.0f, g_uy = y_pass ? g_ty * tz : 0.0f;
  const float g_t0 = g_ux / tz, g_t1 = g_uy / tz;
  g_tz -= (g_ux * ux + g_uy * uy) / tz;
  const float g_t2 = z_pass ? g_tz : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dm[k] += (g_t0 * __ldg(wv + k) + g_t1 * __ldg(wv + 4 + k)) + g_t2 * __ldg(wv + 8 + k);
  }

  // ---- covariance6 backward -------------------------------------------------------
  float gR[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // gr = (G R)[r][k] + G[r][r] R[r][k], G the stripped entries' gradients
    // as a symmetric matrix: d / d R[r][k] = gr u[k], d / d u[k] = sum_r gr R[r][k] / 2
    float gu = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float gr = (G[r][0] * R[0][k] + G[r][1] * R[1][k]) + G[r][2] * R[2][k] +
                       G[r][r] * R[r][k];
      gR[r][k] = gr * u[k];
      gu += gr * R[r][k];
    }
    gu *= 0.5f;
    // u = (s m)^2
    ds[k] = (2.0f * sm[k] * gu) * a.scale_modifier;
  }
  const float gw = 2.0f * (((-z * gR[0][1] + y * gR[0][2]) + (z * gR[1][0] - x * gR[1][2])) +
                           (-y * gR[2][0] + x * gR[2][1]));
  const float gx = 2.0f * (((y * gR[0][1] + z * gR[0][2]) + (y * gR[1][0] - 2.0f * x * gR[1][1])) +
                           ((-w * gR[1][2] + z * gR[2][0]) + (w * gR[2][1] - 2.0f * x * gR[2][2])));
  const float gy = 2.0f * (((-2.0f * y * gR[0][0] + x * gR[0][1]) + (w * gR[0][2] + x * gR[1][0])) +
                           ((z * gR[1][2] - w * gR[2][0]) + (z * gR[2][1] - 2.0f * y * gR[2][2])));
  const float gz = 2.0f * (((-2.0f * z * gR[0][0] - w * gR[0][1]) + (x * gR[0][2] + w * gR[1][0])) +
                           ((-2.0f * z * gR[1][1] + y * gR[1][2]) + (x * gR[2][0] + y * gR[2][1])));
  // through safe_normalize(q): d q = g rq - q rq^3 (g . q)
  const float g_n2 = -0.5f * (rq * rq * rq) * ((gw * q.x + gx * q.y) + (gy * q.z + gz * q.w));
  dq[0] = gw * rq + 2.0f * q.x * g_n2;
  dq[1] = gx * rq + 2.0f * q.y * g_n2;
  dq[2] = gy * rq + 2.0f * q.z * g_n2;
  dq[3] = gz * rq + 2.0f * q.w * g_n2;
}

// One slot's gradients; its SH row's gradient goes to `stage`.
__device__ __forceinline__ void slot_bwd(const Args& a, int64_t i, float* stage) {
  const float g_m2[2] = {load_grad(a.g_means2d, i, a.s_means2d, 0),
                         load_grad(a.g_means2d, i, a.s_means2d, 1)};
  const float g_con[3] = {load_grad(a.g_conics, i, a.s_conics, 0),
                          load_grad(a.g_conics, i, a.s_conics, 1),
                          load_grad(a.g_conics, i, a.s_conics, 2)};
  const float g_col[3] = {load_grad(a.g_colors, i, a.s_colors, 0),
                          load_grad(a.g_colors, i, a.s_colors, 1),
                          load_grad(a.g_colors, i, a.s_colors, 2)};
  const float g_op = load_grad(a.g_opac, i, a.s_opac, 0);
  const bool any_m2 = g_m2[0] != 0.0f || g_m2[1] != 0.0f;
  const bool any_con = g_con[0] != 0.0f || g_con[1] != 0.0f || g_con[2] != 0.0f;
  const bool any_col = g_col[0] != 0.0f || g_col[1] != 0.0f || g_col[2] != 0.0f;

  float dm[3] = {0.0f, 0.0f, 0.0f}, ds[3] = {0.0f, 0.0f, 0.0f};
  float dq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float d_op = 0.0f;
  if (g_op != 0.0f) {
    d_op = f16_flushed(__ldg(a.opacities + i)) ? 0.0f : f16_round(g_op);
  }
  bool staged = false;
  if (any_m2 || any_con || any_col) {
    const float mx = __ldg(a.means3d + 3 * i), my = __ldg(a.means3d + 3 * i + 1),
                mz = __ldg(a.means3d + 3 * i + 2);
    if (any_m2) {
      // px = ((ndc_x + 1) W - 1) / 2, ndc = p_hom[:2] * p_w, p_w = 1 / (p_hom[3] + 1e-7)
      const float* fp = a.full_proj;
      const float h0 = hom_dot(fp, mx, my, mz), h1 = hom_dot(fp + 4, mx, my, mz);
      const float p_w = 1.0f / (hom_dot(fp + 12, mx, my, mz) + W_EPS);
      const float g_n0 = (g_m2[0] * 0.5f) * static_cast<float>(a.width);
      const float g_n1 = (g_m2[1] * 0.5f) * static_cast<float>(a.height);
      const float g_h0 = g_n0 * p_w, g_h1 = g_n1 * p_w;
      const float g_h3 = -(g_n0 * h0 + g_n1 * h1) * (p_w * p_w);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dm[k] += (g_h0 * __ldg(fp + k) + g_h1 * __ldg(fp + 4 + k)) + g_h3 * __ldg(fp + 12 + k);
      }
    }
    if (any_con) conic_bwd(a, i, mx, my, mz, g_con, dm, ds, dq);
    if (any_col) {
      color_bwd(a, i, mx, my, mz, g_col, stage, dm);
      staged = true;
    }
  }
  if (!staged) {
#pragma unroll
    for (int v = 0; v < SH_MAX / 4; ++v) {
      reinterpret_cast<float4*>(stage)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  a.d_means3d[3 * i] = dm[0];
  a.d_means3d[3 * i + 1] = dm[1];
  a.d_means3d[3 * i + 2] = dm[2];
  a.d_scales[3 * i] = ds[0];
  a.d_scales[3 * i + 1] = ds[1];
  a.d_scales[3 * i + 2] = ds[2];
  reinterpret_cast<float4*>(a.d_quats)[i] = make_float4(dq[0], dq[1], dq[2], dq[3]);
  a.d_opac[i] = d_op;
  // means2d = projected + offset: the offset's gradient is means2d's
  if (a.d_offset != nullptr) reinterpret_cast<float2*>(a.d_offset)[i] = make_float2(g_m2[0], g_m2[1]);
}

__global__ void __launch_bounds__(BLOCK) preprocess_bwd_kernel(const Args a) {
  __shared__ __align__(16) float stage[BLOCK * SH_STRIDE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * BLOCK + warp * 32;
  const int64_t i = first + lane;
  if (i < a.n) slot_bwd(a, i, stage + threadIdx.x * SH_STRIDE);
  __syncwarp();
  // the warp's rows as one contiguous run: neighbouring lanes, neighbouring words
  if (first >= a.n) return;
  const int row = a.k * 3;
  const int total = static_cast<int>(min(static_cast<int64_t>(32), a.n - first)) * row;
  float* dst = a.d_shs + first * row;
  const float* src = stage + warp * 32 * SH_STRIDE;
  if ((row & 3) == 0 && (reinterpret_cast<uintptr_t>(a.d_shs) & 15) == 0) {
    for (int f = 4 * lane; f < total; f += 128) {
      const int s = f / row;
      reinterpret_cast<float4*>(dst + f)[0] =
          reinterpret_cast<const float4*>(src + s * SH_STRIDE + (f - s * row))[0];
    }
  } else {
    for (int f = lane; f < total; f += 32) {
      const int s = f / row;
      dst[f] = src[s * SH_STRIDE + (f - s * row)];
    }
  }
}

}  // namespace

extern "C" int gsjax_preprocess_bwd(
    const void* means3d, const void* scales, const void* quats, const void* opacities,
    const void* shs, const void* world_view, const void* full_proj, const void* center,
    const void* tan_fov_x, const void* tan_fov_y, const void* g_means2d, const void* g_conics,
    const void* g_colors, const void* g_opac, int s_means2d, int s_conics, int s_colors,
    int s_opac, void* d_means3d, void* d_scales, void* d_quats, void* d_opac, void* d_shs,
    void* d_offset, int n, int k, int k_used, int width, int height, float scale_modifier,
    void* stream) {
  if (n > 0) {
    Args a;
    a.means3d = static_cast<const float*>(means3d);
    a.scales = static_cast<const float*>(scales);
    a.quats = static_cast<const float*>(quats);
    a.opacities = static_cast<const float*>(opacities);
    a.shs = static_cast<const float*>(shs);
    a.world_view = static_cast<const float*>(world_view);
    a.full_proj = static_cast<const float*>(full_proj);
    a.center = static_cast<const float*>(center);
    a.tan_fov_x = static_cast<const float*>(tan_fov_x);
    a.tan_fov_y = static_cast<const float*>(tan_fov_y);
    a.g_means2d = static_cast<const float*>(g_means2d);
    a.g_conics = static_cast<const float*>(g_conics);
    a.g_colors = static_cast<const float*>(g_colors);
    a.g_opac = static_cast<const float*>(g_opac);
    a.s_means2d = s_means2d;
    a.s_conics = s_conics;
    a.s_colors = s_colors;
    a.s_opac = s_opac;
    a.d_means3d = static_cast<float*>(d_means3d);
    a.d_scales = static_cast<float*>(d_scales);
    a.d_quats = static_cast<float*>(d_quats);
    a.d_opac = static_cast<float*>(d_opac);
    a.d_shs = static_cast<float*>(d_shs);
    a.d_offset = static_cast<float*>(d_offset);
    a.n = n;
    a.k = k;
    a.k_used = k_used;
    a.width = width;
    a.height = height;
    a.scale_modifier = scale_modifier;
    preprocess_bwd_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
