// Ray-box and ray-triangle tests shared by the port's CUDA kernels
// (megakernel.cu: A-F; block_stream.cu: G, I, H).  Each keeps the JAX
// kernels' op order; the sources are built with -fmad=false and IEEE
// div/sqrt, so they agree with the plain PyTorch versions to the last ulp.

#pragma once

#include <math.h>

namespace {

constexpr float kF32Max = 3.402823466e+38f;
constexpr int kIntMax = 2147483647;

}  // namespace

// Slab test with the robust far-plane stretch (Ize 2013) of _tile_slab;
// a NaN slab (0 * inf) opens that axis, as jnp.minimum/maximum + isnan do.
// A NaN window bound (the cpuonly soft-shadow rays of parked shade points
// have NaN directions and tmax) stays NaN through jnp.maximum/minimum and
// fails the test; fmaxf/fminf would drop it and open every block.
__device__ __forceinline__ bool slab(const float* a, const float* o,
                                     const float* inv, float t0, float t1) {
  if (isnan(t0) || isnan(t1)) return false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float lo = (a[k] - o[k]) * inv[k];
    float hi = (a[k + 3] - o[k]) * inv[k];
    float nr, fr;
    if (isnan(lo) || isnan(hi)) {
      nr = -INFINITY;
      fr = INFINITY;
    } else {
      nr = fminf(lo, hi);
      fr = fmaxf(lo, hi) * 1.0000004f;
    }
    t0 = fmaxf(t0, nr);
    t1 = fminf(t1, fr);
  }
  return t0 <= t1;
}

// Moller-Trumbore (query.h:72-132) against the triangle whose 9 planes
// start at T, `stride` floats apart; returns t, or kF32Max on a miss.
__device__ __forceinline__ float mt(const float* T, size_t stride,
                                    float det_eps, const float* o,
                                    const float* d, float tmin, float tmax,
                                    float* uo, float* vo) {
  float v0x = T[0], v0y = T[stride], v0z = T[2 * stride];
  float e1x = T[3 * stride], e1y = T[4 * stride], e1z = T[5 * stride];
  float e2x = T[6 * stride], e2y = T[7 * stride], e2z = T[8 * stride];
  float dx = d[0], dy = d[1], dz = d[2];
  float pvx = dy * e2z - dz * e2y;
  float pvy = dz * e2x - dx * e2z;
  float pvz = dx * e2y - dy * e2x;
  float det = e1x * pvx + e1y * pvy + e1z * pvz;
  float inv_det = 1.0f / (fabsf(det) < det_eps ? 1.0f : det);
  float tvx = o[0] - v0x;
  float tvy = o[1] - v0y;
  float tvz = o[2] - v0z;
  float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  float qvx = tvy * e1z - tvz * e1y;
  float qvy = tvz * e1x - tvx * e1z;
  float qvz = tvx * e1y - tvy * e1x;
  float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *uo = u;
  *vo = v;
  bool ok = fabsf(det) >= det_eps && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
            u + v <= 1.0f && t >= tmin && t <= tmax;
  return ok ? t : kF32Max;
}

struct Hit {
  float t, u, v;
  int id, k;  // global triangle id (-1: none), grid slot block*B + lane
};

// The lexicographic (t, global triangle id) take rule: the winner does not
// depend on the order in which triangles are visited.
__device__ __forceinline__ void take(Hit& h, float t, float u, float v,
                                     int id, int k) {
  if (t < kF32Max &&
      (t < h.t || (t == h.t && id < (h.id >= 0 ? h.id : kIntMax)))) {
    h.t = t;
    h.u = u;
    h.v = v;
    h.id = id;
    h.k = k;
  }
}
