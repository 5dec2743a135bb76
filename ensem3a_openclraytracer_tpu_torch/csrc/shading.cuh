// Per-lane shading of one fused Monte-Carlo sample, shared by
// csrc/fused_sample.cu (one block, state in registers) and csrc/fused_queue.cu
// (any number of blocks, state in device memory between the traces).  Term for
// term as ops/fused.sample_fused_plain: the random draws, the NEE light point
// and its contribution, Lambert / GGX / tint-glass bounce sampling
// (ops/bsdf.sample_bounce) and the sun's glass tint; and the escape's lat-long
// IBL lookup (ops/envmap.sample_ibl) for the launches that add the samples up
// themselves: csrc/fused_sample.cu's whole-render launch and
// csrc/fused_queue.cu's sample launch given a running sum.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace shade {

constexpr float PI = 3.14159265358979323846f;
constexpr float SQRT_2_OVER_PI = 0.79788456080286535588f;
constexpr int EMISSIVE = 0, GLOSSY = 2, GLASS = 3;
// float32 constants of ops/envmap.spherical_uv: 0.5 / PI and 1 / PI with PI
// the float32 pi of ops/sampling
constexpr float HALF_INV_PI = static_cast<float>(0.5 / 3.14159274101257324219);
constexpr float INV_PI = static_cast<float>(1.0 / 3.14159274101257324219);
constexpr int N_ATTR = 8;  // [nx, ny, nz, material type, r, g, b, roughness] per triangle

// The emissive triangles of ops/fused.sample_fused's LightPack, one pointer
// per column.
struct Lights {
  const float* __restrict__ v0;     // [n_lights, 3]
  const float* __restrict__ v1;     // [n_lights, 3]
  const float* __restrict__ v2;     // [n_lights, 3]
  const float* __restrict__ n;      // [n_lights, 3] unit normal
  const float* __restrict__ power;  // [n_lights]
  const float* __restrict__ area;   // [n_lights]
  int count;
};

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// GGX + Schlick + Smith BRDF, term for term as ops/bsdf.eval_ggx.
__device__ __forceinline__ void ggx(const float color[3], float rough, const float v[3],
                                    const float l[3], const float n[3], float out[3]) {
  float h[3] = {l[0] + v[0], l[1] + v[1], l[2] + v[2]};
  const float hs = 1.0f / sqrtf(fmaxf(dot3(h, h), 1e-20f));
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = h[k] * hs;
  const float alpha_sqr = rough * rough;
  const float ndoth = fmaxf(dot3(n, h), 0.0f);
  const float q = ndoth * ndoth * (alpha_sqr - 1.0f) + 1.0f;
  const float d_den = fmaxf(PI * (q * q), 1e-12f);
  const float kk = rough * SQRT_2_OVER_PI;
  const float ndotv = fmaxf(dot3(n, v), 0.0f);
  const float ndotl = fmaxf(dot3(n, l), 0.0f);
  const float g1_den = fmaxf(ndotv * (1.0f - kk) + kk, 1e-12f);
  const float g2_den = fmaxf(ndotl * (1.0f - kk) + kk, 1e-12f);
  const float one_m_hv = 1.0f - fmaxf(dot3(h, v), 0.0f);
  const float p2 = one_m_hv * one_m_hv;
  const float fr = 0.04f + 0.96f * (p2 * p2 * one_m_hv);
  const float spec = (fr * alpha_sqr * ndotv * ndotl) /
                     fmaxf(d_den * g1_den * g2_den * fmaxf(4.0f * ndotv * ndotl, 1e-3f), 1e-12f);
  const float kd = (1.0f - fr) * 0.5f;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = kd * color[k] / PI + spec;
}

// The n_u uniforms of (bounce, lane) slot `row` into u[0, n_u): explicit
// uniforms [.., n_u] when given, else the Philox stream of `key` for `sample`
// at flat index row * n_u + k.
__device__ __forceinline__ void draw(const float* __restrict__ uniforms, uint2 key, int sample,
                                     int n_u, long long row, float u[5]) {
  if (uniforms != nullptr) {
#pragma unroll
    for (int k = 0; k < 5; ++k)
      if (k < n_u) u[k] = uniforms[row * n_u + k];
  } else {
    const unsigned long long f0 = static_cast<unsigned long long>(row) * n_u;
    unsigned long long cur = ~0ull;
    uint4 blk = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (k < n_u) {
        const unsigned long long f = f0 + k;
        if ((f >> 2) != cur) {
          cur = f >> 2;
          blk = philox::block(cur, static_cast<unsigned>(sample), key);
        }
        u[k] = philox::to_unit(philox::word(blk, static_cast<int>(f & 3)));
      }
    }
  }
}

// NEE: the light point of u[2..4] seen from p (normal n): the light's index,
// the unit direction to the point, dist2 = max(|delta|^2, 1e-8), its root and
// the two cosines.
__device__ __forceinline__ void light_point(const Lights& L, const float u[5], const float p[3],
                                            const float n[3], int& li, float ldir[3],
                                            float& dist2, float& dist, float& cos_s,
                                            float& cos_l) {
  li = min(max(static_cast<int>(u[2] * static_cast<float>(L.count)), 0), L.count - 1);
  const float sx = sqrtf(u[3]);
  float delta[3], ln[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a0 = L.v0[3 * li + k];
    const float xl = a0 + (L.v1[3 * li + k] - a0) * (1.0f - sx) +
                     (L.v2[3 * li + k] - a0) * (u[4] * sx);
    delta[k] = xl - p[k];
    ln[k] = L.n[3 * li + k];
  }
  dist2 = fmaxf(dot3(delta, delta), 1e-8f);
  dist = sqrtf(dist2);
#pragma unroll
  for (int k = 0; k < 3; ++k) ldir[k] = delta[k] / dist;
  cos_s = dot3(ldir, n);
  cos_l = fabsf(dot3(ldir, ln));
}

// NEE: the BRDF toward the light point and the scalar s of its
// contribution thr * brdf * s (when the point is visible).
__device__ __forceinline__ float light_weight(const Lights& L, int li, int mtype,
                                              const float color[3], float rough,
                                              const float in_d[3], const float ldir[3],
                                              const float n[3], float cos_s, float cos_l,
                                              float dist2, float brdf[3]) {
  if (mtype == GLOSSY) {
    const float v[3] = {-in_d[0], -in_d[1], -in_d[2]};
    ggx(color, rough, v, ldir, n, brdf);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) brdf[k] = color[k] / PI;
  }
  const float weight = (static_cast<float>(L.count) * L.area[li]) * cos_l / dist2;
  return fmaxf(cos_s, 0.0f) * weight * L.power[li];
}

// Bounce sampling as ops/bsdf.sample_bounce (tint glass): cosine / uniform
// hemisphere directions in the Frisvad / Duff basis; a live lane's
// throughput takes the sample's factor.
__device__ __forceinline__ void bounce(const float n[3], const float in_d[3], const float color[3],
                                       float rough, int mtype, bool live, float u1, float u2,
                                       float bdir[3], float thr[3]) {
  const float sign = n[2] >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n[2]);
  const float bb = n[0] * n[1] * a;
  const float tg[3] = {1.0f + sign * n[0] * n[0] * a, sign * bb, -sign * n[0]};
  const float bt[3] = {bb, sign + n[1] * n[1] * a, -n[1]};
  const float phi = (2.0f * PI) * u2;
  const float cphi = cosf(phi), sphi = sinf(phi);
  const float rr = sqrtf(u1);
  const float z_cos = sqrtf(fmaxf(0.0f, 1.0f - u1));
  const float invpdf_diff = PI / fmaxf(z_cos, 1e-6f);
  const float cos_u = 1.0f - u1;
  const float sin_u = sqrtf(fmaxf(0.0f, 1.0f - cos_u * cos_u));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d_diff = tg[k] * (rr * cphi) + bt[k] * (rr * sphi) + n[k] * z_cos;
    const float d_unif = tg[k] * (sin_u * cphi) + bt[k] * (sin_u * sphi) + n[k] * cos_u;
    bdir[k] = mtype == GLASS ? in_d[k] : mtype == GLOSSY ? d_unif : d_diff;
  }
  const float cos_abs = fabsf(dot3(bdir, n));
  if (live) {
    if (mtype == GLASS) {
#pragma unroll
      for (int k = 0; k < 3; ++k) thr[k] = thr[k] * color[k];
    } else if (mtype == GLOSSY) {
      const float v[3] = {-in_d[0], -in_d[1], -in_d[2]};
      float brdf[3];
      ggx(color, rough, v, bdir, n, brdf);
#pragma unroll
      for (int k = 0; k < 3; ++k) thr[k] = thr[k] * (brdf[k] * ((2.0f * PI) * cos_abs));
    } else {
      const float s = invpdf_diff * cos_abs;
#pragma unroll
      for (int k = 0; k < 3; ++k) thr[k] = thr[k] * (color[k] / PI * s);
    }
  }
}

// The sun's light at an escaping vertex of type mtype: full power when its
// shadow ray is unoccluded (and the vertex is not glass), tinted by the
// colour of a glass occluder (attribute row sa of triangle stri).
__device__ __forceinline__ void add_sun(const float* __restrict__ attrs, bool shit, int stri,
                                        int mtype, const float thr[3], float sun_power,
                                        float rad[3]) {
  const float* sa = attrs + N_ATTR * stri;
  const bool unocc = !shit && mtype != GLASS;
  const bool glass_occ = shit && __float2int_rn(sa[3]) == GLASS;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sun_light = (unocc ? 1.0f : 0.0f) * sun_power +
                            (glass_occ ? 1.0f : 0.0f) * sa[4 + k] * sun_power;
    rad[k] += thr[k] * sun_light;
  }
}

// The environment image seen along d, times its power: ops/envmap.sample_ibl
// (ibl, d, bilinear) * ibl_power, operation for operation (the products and
// sums rounded one at a time, as the tensor ops round them: no fused
// multiply-add).  tex is the [h, w, 3] f32 image, read in place through the
// read-only path (an 8k map is ~400 MB, so nothing is staged).  Indices
// truncate toward zero and clamp to the edge, as .to(int64) and clamp do.
__device__ __forceinline__ void ibl(const float* __restrict__ tex, int h, int w, bool bilinear,
                                    float power, const float d[3], float out[3]) {
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                             __fmul_rn(d[2], d[2]));
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(ss, 1e-20f)));
  const float rx = __fmul_rn(d[1], inv), ry = -__fmul_rn(d[2], inv), rz = -__fmul_rn(d[0], inv);
  const float u = __fadd_rn(__fmul_rn(atan2f(rz, rx), HALF_INV_PI), 0.5f);
  const float v = __fadd_rn(__fmul_rn(asinf(fminf(fmaxf(ry, -1.0f), 1.0f)), INV_PI), 0.5f);
  float x = __fmul_rn(u, static_cast<float>(w));
  float y = __fmul_rn(v, static_cast<float>(h));
  auto texel = [&](long long yi, long long xi, int k) {
    return __ldg(tex + (yi * w + xi) * 3 + k);
  };
  if (!bilinear) {
    const long long xi = min(max(static_cast<long long>(x), 0ll), static_cast<long long>(w - 1));
    const long long yi = min(max(static_cast<long long>(y), 0ll), static_cast<long long>(h - 1));
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = __fmul_rn(texel(yi, xi, k), power);
    return;
  }
  x = __fsub_rn(x, 0.5f);
  y = __fsub_rn(y, 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const long long wm = w - 1, hm = h - 1;
  const long long x0i = min(max(static_cast<long long>(x0), 0ll), wm);
  const long long x1i = min(max(x0i + 1, 0ll), wm);
  const long long y0i = min(max(static_cast<long long>(y0), 0ll), hm);
  const long long y1i = min(max(y0i + 1, 0ll), hm);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float top = __fadd_rn(__fmul_rn(texel(y0i, x0i, k), gx), __fmul_rn(texel(y0i, x1i, k), fx));
    const float bot = __fadd_rn(__fmul_rn(texel(y1i, x0i, k), gx), __fmul_rn(texel(y1i, x1i, k), fx));
    out[k] = __fmul_rn(__fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy)), power);
  }
}

}  // namespace shade
