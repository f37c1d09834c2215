// Path-tracing kernels for Hopper (sm_90a): emit, bounce_step, resume and
// the monolithic render, and the staged integrator's closest-hit and
// occlusion kernels.
//
// Replaces the Pallas TPU kernels of raytracinginonesemester_tpu/ops/
// megakernel.py: _emit_kernel (emit_tiles), _bounce_step_kernel
// (bounce_step_tiles), _resume_kernel (resume_tiles) and _render_kernel
// (render_tiles), in both reference dialects, and _bounce_step_kernel's
// oracle rows (diff_out) with its binned depth 0 (cand_*); and of
// ops/pallas_kernels.py:
// _closest_kernel (pallas_block_closest) and _occluded_kernel
// (pallas_block_occluded), the staged integrator's closest_kernel and
// occluded_kernel below.  The kernels share the
// device functions below, as the Pallas kernels share _make_traverse /
// _make_shade / _make_bounce; the dialect is a template argument (CPU =
// the cpuonly dialect: pixel-center jitter, sky-gradient misses,
// disk-sampled soft shadows, the (kd + kr)-weighted throughput rules).
//
// Design.  One thread per ray, 128 threads per block.  Thread (tile, lane)
// reads state row k at tile*16*rt + k*rt + lane, so each row load of a warp
// is coalesced.  Triangle planes stay in global memory (frog at 512-blocks
// is ~1.7 MB and lives in L2); block AABBs, lights and materials are staged
// in shared memory.  Closest hit either scans blocks 0..L-1 with a per-ray
// slab test against the running best t before each block's triangle loop
// (the per-ray form of the Pallas tile-level gate), or, at depth 0 with a
// binned camera plan (ops/binned.py), walks the tile's candidate chunks:
// every thread of a CUDA block lies in one 512-ray tile, so each load of a
// chunk's row is one address for the whole warp (a broadcast); the chunks
// are read straight from global memory, not staged in shared memory.  The
// lexicographic (t, global triangle id) take rule makes the winner
// independent of visit order.  Shadow rays stop at their first hit.  The
// hemisphere and disk samplers are the reference's scalar rejection loops
// (query.h:51-71, raytracer.h:77-85), capped at 64 rounds.
//
// What bounds it on this card: divergent scalar FP32 work (Moller-Trumbore
// per ray-triangle pair, shadow walks, rejection sampling) and L2-resident
// triangle reads; there is nothing matrix-shaped for the tensor cores.
// This version is deliberately simple: exact and readable, with the JAX
// kernels' op order (built with -fmad=false and IEEE div/sqrt) so that it
// can be held against them to the last ulp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStRows = 16;
constexpr int kCandRows = 16;
constexpr int kThreads = 128;
constexpr float kF32Max = 3.402823466e+38f;
constexpr int kIntMax = 2147483647;
constexpr float kInvPi = 0.31830988618f;
constexpr float kInv2Pi = 0.15915494309f;

}  // namespace

// Mirrored by raytracinginonesemester_tpu_torch/ops/_native.py:SceneArgs.
struct SceneArgs {
  const float* cam;     // (16,) center, pixel00, du, dv, miss rgb, 0
  const float* lights;  // (NL, 8) pos, color*intensity, radius, 0
  const float* mats;    // (NO, 16) albedo, kd, specular, ks, shin, kr, emission
  const float* tri;     // (9, L, B) v0 xyz, e1 xyz, e2 xyz
  const float* norm;    // (12, L, B) n0 n1 n2 xyz, geometric normal xyz
  const int* ids;       // (L, B) global triangle id, -1 padding
  const int* obj;       // (L, B) object id
  const float* aabb;    // (L, 8) min xyz, max xyz, 0, 0
  const int* cand_meta;      // (nt, 8) first chunk, chunk count (binned)
  const float* cand_stream;  // (chunks * 16, C) planes, id, home, slot
  int n_lights;
  int n_objects;
  int num_blocks;
  int block_size;
  int diffuse_bounce;
  int cpuonly;
  int shadow_samples;  // soft-shadow walks per area light (cpuonly)
  int cand_chunk;      // C; 0: depth 0 takes the flat block scan
  float det_eps;
  float tmin;
  float shadow_eps;
  float shadow_tmin;
};

struct Shared {
  const float* aabb;    // (L, 6)
  const float* lights;  // (NL, 8)
  const float* mats;    // (NO, 16)
};

struct Ray {
  float bo[3], bd[3], tp[3], rd[3];
  float alive;
  uint32_t rng;
};

// ---- RNG, bit-compatible with core/rng.py (query.h:32-48) ----

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h = (h ^ 61u) ^ (h >> 16);
  h *= 9u;
  h ^= h >> 4;
  h *= 0x27D4EB2Du;
  h ^= h >> 15;
  return h;
}

__device__ __forceinline__ uint32_t lcg(uint32_t s) {
  return s * 1664525u + 1013904223u;
}

__device__ __forceinline__ float wang_float(uint32_t h) {
  return __uint2float_rn(mix32(h)) * 2.3283064365386963e-10f;  // 2^-32
}

// clip to [0, 1] that keeps NaN, as jnp.clip / torch.clamp do
__device__ __forceinline__ float clip01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// ---- geometry ----

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

// The oracle rows of one bounce (bounce_step_tiles(diff_out=True)): the
// winner's t, u, v and global id, the per-light visibility bits and the
// decision bits (1 found, 2 diffuse, 4 mirror, 8 alive after).  The
// defaults are a dead lane's.
struct Capture {
  float t = kF32Max, u = 0.0f, v = 0.0f;
  int id = -1, vis = 0, dec = 0;
};

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

__device__ Hit closest(const SceneArgs& s, const Shared& sh, const float* o,
                       const float* d, float tmin) {
  const size_t plane = (size_t)s.num_blocks * s.block_size;
  float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  for (int b = 0; b < s.num_blocks; ++b) {
    if (!slab(sh.aabb + 6 * b, o, inv, tmin, h.t)) continue;
    const int base = b * s.block_size;
    for (int j = 0; j < s.block_size; ++j) {
      const int id = s.ids[base + j];
      if (id < 0) continue;
      float u, v;
      float t = mt(s.tri + base + j, plane, s.det_eps, o, d, tmin, h.t, &u, &v);
      take(h, t, u, v, id, base + j);
    }
  }
  return h;
}

// The binned walk (ops/binned.py): the tile's candidate chunks, dense
// Moller-Trumbore on every live lane; the winner's grid slot (row 11) is
// where its attributes are read.
__device__ Hit closest_binned(const SceneArgs& s, int tile, const float* o,
                              const float* d) {
  const int c_w = s.cand_chunk;
  const int first = s.cand_meta[8 * tile];
  const int count = s.cand_meta[8 * tile + 1];
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  for (int c = first; c < first + count; ++c) {
    const float* rows = s.cand_stream + (size_t)c * kCandRows * c_w;
    for (int j = 0; j < c_w; ++j) {
      const int id = (int)rows[9 * c_w + j];  // exact integers in f32
      if (id < 0) continue;
      float u, v;
      float t = mt(rows + j, c_w, s.det_eps, o, d, s.tmin, h.t, &u, &v);
      take(h, t, u, v, id, (int)rows[11 * c_w + j]);
    }
  }
  return h;
}

// Shading normal of the winner.  gpu: geometric sidedness, zero-length
// fallback, hemisphere alignment (query.h:113-126); cpuonly: the
// normalised interpolation flipped to the face normal's side
// (CPUOnly/include/ray.h:76-92).
template <bool CPU>
__device__ void shading_normal(const SceneArgs& s, const Hit& h,
                               const float* d, float* n) {
  const size_t plane = (size_t)s.num_blocks * s.block_size;
  const float* N = s.norm + h.k;
  float nv[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) nv[q] = N[q * plane];
  float w = 1.0f - h.u - h.v;
  float snx = w * nv[0] + h.u * nv[3] + h.v * nv[6];
  float sny = w * nv[1] + h.u * nv[4] + h.v * nv[7];
  float snz = w * nv[2] + h.u * nv[5] + h.v * nv[8];
  float gx = nv[9], gy = nv[10], gz = nv[11];
  float dg = d[0] * gx + d[1] * gy + d[2] * gz;
  float gsign = dg < 0.0f ? 1.0f : -1.0f;
  float len_sq = snx * snx + sny * sny + snz * snz;
  if (CPU) {
    float sc = (1.0f / sqrtf(fmaxf(len_sq, 1e-24f))) * gsign;
    n[0] = snx * sc;
    n[1] = sny * sc;
    n[2] = snz * sc;
    return;
  }
  float ogx = gx * gsign, ogy = gy * gsign, ogz = gz * gsign;
  float inv_len = 1.0f / sqrtf(fmaxf(len_sq, 1e-38f));
  bool use_geom = len_sq < 1e-12f;
  snx = use_geom ? ogx : snx * inv_len;
  sny = use_geom ? ogy : sny * inv_len;
  snz = use_geom ? ogz : snz * inv_len;
  float fs = (snx * ogx + sny * ogy + snz * ogz) < 0.0f ? -1.0f : 1.0f;
  n[0] = snx * fs;
  n[1] = sny * fs;
  n[2] = snz * fs;
}

// Any hit (IsInShadow): blocks culled on [tmin, dist], triangles tested on
// [tmin, tmax]; the walk stops at the first hit.
__device__ bool occluded(const SceneArgs& s, const Shared& sh, const float* p,
                         const float* ld, float tmin, float dist, float tmax) {
  const size_t plane = (size_t)s.num_blocks * s.block_size;
  float inv[3] = {1.0f / ld[0], 1.0f / ld[1], 1.0f / ld[2]};
  for (int b = 0; b < s.num_blocks; ++b) {
    if (!slab(sh.aabb + 6 * b, p, inv, tmin, dist)) continue;
    const int base = b * s.block_size;
    for (int j = 0; j < s.block_size; ++j) {
      if (s.ids[base + j] < 0) continue;
      float u, v;
      if (mt(s.tri + base + j, plane, s.det_eps, p, ld, tmin, tmax, &u, &v) <
          kF32Max)
        return true;
    }
  }
  return false;
}

// random_on_hemisphere (query.h:51-71): scalar rejection, <= 64 rounds.
__device__ void hemisphere(uint32_t* rng, const float* n, float* h) {
  uint32_t st = *rng;
  for (int k = 0; k < 64; ++k) {
    uint32_t s1 = lcg(st);
    float x = 2.0f * wang_float(s1) - 1.0f;
    uint32_t s2 = lcg(s1);
    float y = 2.0f * wang_float(s2) - 1.0f;
    uint32_t s3 = lcg(s2);
    float z = 2.0f * wang_float(s3) - 1.0f;
    st = s3;
    float lensq = x * x + y * y + z * z;
    if (lensq > 1e-10f && lensq <= 1.0f) {
      float inv = 1.0f / sqrtf(fmaxf(lensq, 1e-10f));
      h[0] = x * inv;
      h[1] = y * inv;
      h[2] = z * inv;
      break;
    }
  }
  *rng = st;
  float dot = h[0] * n[0] + h[1] * n[1] + h[2] * n[2];
  float fs = dot > 0.0f ? 1.0f : -1.0f;
  h[0] *= fs;
  h[1] *= fs;
  h[2] *= fs;
}

// random_in_unit_disk (raytracer.h:77-85): scalar rejection, <= 64
// rounds, two draws per round; (0, 0) if never accepted.
__device__ void disk_sample(uint32_t* rng, float* xo, float* yo) {
  uint32_t st = *rng;
  *xo = 0.0f;
  *yo = 0.0f;
  for (int k = 0; k < 64; ++k) {
    uint32_t s1 = lcg(st);
    float x = 2.0f * wang_float(s1) - 1.0f;
    uint32_t s2 = lcg(s1);
    float y = 2.0f * wang_float(s2) - 1.0f;
    st = s2;
    float r2 = x * x + y * y;
    if (r2 > 1e-10f && r2 <= 1.0f) {
      *xo = x;
      *yo = y;
      break;
    }
  }
  *rng = st;
}

// One cpuonly shadow walk from p along st (not normalised): 1 if nothing
// blocks [shadow_tmin, |st| - shadow_eps], else 0.
__device__ float soft_walk(const SceneArgs& s, const Shared& sh,
                           const float* p, float stx, float sty, float stz,
                           bool facing) {
  float d_s = sqrtf(fmaxf(stx * stx + sty * sty + stz * stz, 1e-24f));
  float inv_s = 1.0f / d_s;
  float sld[3] = {stx * inv_s, sty * inv_s, stz * inv_s};
  if (!facing) return 1.0f;
  return occluded(s, sh, p, sld, s.shadow_tmin, d_s, d_s - s.shadow_eps)
             ? 0.0f
             : 1.0f;
}

// ShadowVisibility (CPUOnly/raytracer.h:121-168): shadow_samples walks
// toward disk samples of an area light (the draws advance the ray's rng),
// one toward a point light's center.
__device__ float soft_visibility(const SceneArgs& s, const Shared& sh,
                                 const float* L, const float* p,
                                 const float* to, const float* ld,
                                 bool facing, uint32_t* rng) {
  const float radius = L[6];
  if (!(radius > 0.0f))
    return soft_walk(s, sh, p, to[0], to[1], to[2], facing) / 1.0f;
  // disk basis around w = (p - light) / |p - light| (raytracer.h:88-93)
  const float wx = -ld[0], wy = -ld[1], wz = -ld[2];
  const bool use_y = fabsf(wx) > 0.9f;
  const float a0 = use_y ? 0.0f : 1.0f;
  const float a1 = use_y ? 1.0f : 0.0f;
  float tx = a1 * wz;
  float ty = -a0 * wz;
  float tz = a0 * wy - a1 * wx;
  const float t_inv = 1.0f / sqrtf(tx * tx + ty * ty + tz * tz);
  tx = tx * t_inv;
  ty = ty * t_inv;
  tz = tz * t_inv;
  const float bx = wy * tz - wz * ty;
  const float by = wz * tx - wx * tz;
  const float bz = wx * ty - wy * tx;
  float unocc = 0.0f;
  for (int k = 0; k < s.shadow_samples; ++k) {
    float dxs, dys;
    disk_sample(rng, &dxs, &dys);
    const float spx = L[0] + (tx * dxs + bx * dys) * radius;
    const float spy = L[1] + (ty * dxs + by * dys) * radius;
    const float spz = L[2] + (tz * dxs + bz * dys) * radius;
    unocc = unocc +
            soft_walk(s, sh, p, spx - p[0], spy - p[1], spz - p[2], facing);
  }
  return unocc / (float)s.shadow_samples;
}

// One closest hit + direct light + Russian-roulette step on an alive ray
// (the loop body of TraceRayIterative, query.h:165-216, or of CPUOnly's
// TraceRay).  tile >= 0: closest hit walks that tile's binned candidates.
// DIFF (gpu dialect only): also fill *cap with the oracle rows; the other
// instantiations compile without it.
template <bool CPU, bool DIFF = false>
__device__ void bounce(const SceneArgs& s, const Shared& sh, const float* cam,
                       Ray& r, int tile, Capture* cap = nullptr) {
  const float* o = r.bo;
  const float* d = r.bd;
  Hit h = tile >= 0 ? closest_binned(s, tile, o, d)
                     : closest(s, sh, o, d, s.tmin);
  const bool hit = h.t < kF32Max;
  float n[3] = {0.0f, 0.0f, 1.0f};
  int obj = 0;
  if (hit) {
    shading_normal<CPU>(s, h, d, n);
    obj = s.obj[h.k];
  }
  const float* m = sh.mats + 16 * obj;

  // ---- direct light (ShadeDirect, shader.h:65-110) ----
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = hit ? o[c] + h.t * d[c] + n[c] * s.shadow_eps : 1e30f;
  const float vx = -d[0], vy = -d[1], vz = -d[2];
  const float ndotv = fmaxf(n[0] * vx + n[1] * vy + n[2] * vz, 0.0f);
  float lo[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) lo[c] = m[c] * 0.05f + m[10 + c];
  for (int li = 0; li < s.n_lights; ++li) {
    const float* L = sh.lights + 8 * li;
    float to[3] = {L[0] - p[0], L[1] - p[1], L[2] - p[2]};
    float dist = sqrtf(fmaxf(to[0] * to[0] + to[1] * to[1] + to[2] * to[2],
                             CPU ? 1e-24f : 1e-38f));
    float inv_dist = 1.0f / dist;
    float ld[3] = {to[0] * inv_dist, to[1] * inv_dist, to[2] * inv_dist};
    float ndotl = fmaxf(n[0] * ld[0] + n[1] * ld[1] + n[2] * ld[2], 0.0f);
    bool facing = hit && ndotl > 0.0f && ndotv > 0.0f;
    float vis;
    if (CPU) {
      if (!hit) continue;  // a miss draws nothing and adds nothing
      vis = soft_visibility(s, sh, L, p, to, ld, facing, &r.rng);
    } else {
      vis = 1.0f;
    }
    if (!facing) continue;  // scale == 0: adds exactly 0
    if (!CPU)
      vis = occluded(s, sh, p, ld, s.shadow_tmin, dist, dist) ? 0.0f : 1.0f;
    if (DIFF && vis > 0.0f) cap->vis |= 1 << li;
    float hx = ld[0] + vx, hy = ld[1] + vy, hz = ld[2] + vz;
    float hlen = sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-38f));
    float ndoth = fmaxf((n[0] * hx + n[1] * hy + n[2] * hz) / hlen, 0.0f);
    float scale = ndotl * vis;  // lit == 1: facing
    float shin = m[8];
    float lobe = powf(ndoth, shin) * ((shin + 2.0f) * kInv2Pi * m[7]);
    float fd = m[3] * kInvPi;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      lo[c] = lo[c] + scale * L[3 + c] * (m[c] * fd + m[4 + c] * lobe);
  }

  // ---- radiance and the Russian-roulette split (query.h:188-212) ----
  float ms[3];
  if (CPU) {
    // miss shader: the sky gradient on the unit direction
    // (CPUOnly/raytracer.h:226-229)
    const float skyt = 0.5f * (d[2] + 1.0f);
    ms[0] = (1.0f - skyt) + skyt * 0.5f;
    ms[1] = (1.0f - skyt) + skyt * 0.7f;
    ms[2] = (1.0f - skyt) + skyt * 1.0f;
  } else {
    ms[0] = cam[12];
    ms[1] = cam[13];
    ms[2] = cam[14];
  }
  const float found_f = hit ? 1.0f : 0.0f;
  const float missed_f = hit ? 0.0f : 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    r.rd[c] = r.rd[c] + r.tp[c] * (missed_f * ms[c] + found_f * lo[c]);
  const float kd = m[3], kr = m[9];
  const float total = kd + kr;
  const bool can_bounce = hit && total > 0.0f;
  const uint32_t s_xi = lcg(r.rng);
  const float xi = wang_float(s_xi);
  if (can_bounce) r.rng = s_xi;
  const float ratio = kd / (total > 0.0f ? total : 1.0f);
  const bool take_diff = s.diffuse_bounce && can_bounce && xi < ratio;
  // CPUOnly mirrors only when kr > 0 (raytracer.h:249)
  const bool take_mirror = can_bounce && !take_diff && (!CPU || kr > 0.0f);
  float hm[3] = {0.0f, 0.0f, 0.0f};
  if (take_diff) hemisphere(&r.rng, n, hm);
  const float ndotl_h =
      fmaxf(n[0] * hm[0] + n[1] * hm[1] + n[2] * hm[2], 0.0f);
  // diffuse throughput albedo * 2 N.L (query.h:195-199), times (kd + kr)
  // in CPUOnly (raytracer.h:240-248); its mirror scales by kd + kr when
  // diffuse bounces are on (raytracer.h:249-255)
  const float dtp = CPU ? total * (2.0f * ndotl_h) : 2.0f * ndotl_h;
  const float mirror_scale = (CPU && s.diffuse_bounce) ? total : kr;
  const float ddn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  const float td_f = take_diff ? 1.0f : 0.0f;
  const bool bounced = take_diff || take_mirror;
  const float b_f = bounced ? 1.0f : 0.0f;
  float nd[3], tp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rf = d[c] - 2.0f * ddn * n[c];
    nd[c] = b_f * (td_f * hm[c] + (1.0f - td_f) * rf) + (1.0f - b_f) * d[c];
    float tsc =
        td_f * (m[c] * dtp) + (1.0f - td_f) * (m[4 + c] * mirror_scale);
    tp[c] = b_f * (r.tp[c] * tsc) + (1.0f - b_f) * r.tp[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (bounced) r.bo[c] = p[c];
    r.bd[c] = nd[c];
    r.tp[c] = tp[c];
  }
  const bool tiny = tp[0] < 1e-4f && tp[1] < 1e-4f && tp[2] < 1e-4f;
  r.alive = (bounced && !tiny) ? 1.0f : 0.0f;
  if (DIFF) {
    cap->t = h.t;
    cap->u = h.u;
    cap->v = h.v;
    cap->id = h.id;
    cap->dec = (hit ? 1 : 0) | (take_diff ? 2 : 0) | (take_mirror ? 4 : 0) |
               (r.alive > 0.0f ? 8 : 0);
  }
}

// Camera ray of one sample (query.cu:36-43, camera.h:49-53): Wang jitter
// or the pixel center; the rng seed is make_rng_seed(x, y, sample).
__device__ void primary(const float* cam, int xi, int yi, uint32_t sample,
                        bool center, Ray& r) {
  const uint32_t x = (uint32_t)xi, y = (uint32_t)yi;
  const uint32_t h = (x * 73856093u ^ y * 19349663u) ^ (sample * 83492791u);
  const float jx = center ? 0.5f : wang_float(h) - 0.5f;
  const float jy = center ? 0.5f : wang_float(lcg(h)) - 0.5f;
  const float px = (float)xi + jx;
  const float py = (float)yi + jy;
  float rv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rv[c] = (cam[3 + c] + px * cam[6 + c] + py * cam[9 + c]) - cam[c];
  const float rlen = sqrtf(rv[0] * rv[0] + rv[1] * rv[1] + rv[2] * rv[2]);
  for (int c = 0; c < 3; ++c) {
    r.bo[c] = cam[c];
    r.bd[c] = rv[c] / rlen;
    r.tp[c] = 1.0f;
    r.rd[c] = 0.0f;
  }
  r.alive = 1.0f;
  r.rng = h;
}

// ---- kernels ----

__device__ Shared stage_shared(const SceneArgs& s) {
  extern __shared__ float smem[];
  float* aabb = smem;
  float* lights = aabb + 6 * s.num_blocks;
  float* mats = lights + 8 * s.n_lights;
  for (int i = threadIdx.x; i < 6 * s.num_blocks; i += blockDim.x)
    aabb[i] = s.aabb[(i / 6) * 8 + i % 6];
  for (int i = threadIdx.x; i < 8 * s.n_lights; i += blockDim.x)
    lights[i] = s.lights[i];
  for (int i = threadIdx.x; i < 16 * s.n_objects; i += blockDim.x)
    mats[i] = s.mats[i];
  __syncthreads();
  return Shared{aabb, lights, mats};
}

__device__ __forceinline__ void load_ray(const float* st, const int* rng,
                                         int rt, Ray& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.bo[c] = st[c * rt];
    r.bd[c] = st[(3 + c) * rt];
    r.tp[c] = st[(6 + c) * rt];
    r.rd[c] = st[(9 + c) * rt];
  }
  r.alive = st[12 * rt];
  r.rng = (uint32_t)rng[0];
}

__device__ __forceinline__ void store_ray(const Ray& r, int rt, float* st,
                                          int* rng) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    st[c * rt] = r.bo[c];
    st[(3 + c) * rt] = r.bd[c];
    st[(6 + c) * rt] = r.tp[c];
    st[(9 + c) * rt] = r.rd[c];
  }
  st[12 * rt] = r.alive;
  for (int k = 13; k < kStRows; ++k) st[k * rt] = 0.0f;
  rng[0] = (int)r.rng;
  for (int k = 1; k < 8; ++k) rng[k * rt] = 0;
}

template <bool CPU>
__global__ void __launch_bounds__(kThreads)
emit_kernel(SceneArgs s, const int* xs, const int* ys, const int* has_work,
            int n_rays, int rt, int sample_offset, int center, float* st_out,
            int* rng_out) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;
  const int tile = gid / rt, lane = gid % rt;
  float* so = st_out + (size_t)tile * kStRows * rt + lane;
  int* ro = rng_out + (size_t)tile * 8 * rt + lane;
  const float* cam = s.cam;
  Ray r;
  if (!has_work[tile]) {
    // no ray of this tile can hit: dead, unit direction, miss radiance
    for (int c = 0; c < 3; ++c) {
      r.bo[c] = 0.0f;
      r.bd[c] = c == 2 ? 1.0f : 0.0f;
      r.tp[c] = 0.0f;
      r.rd[c] = cam[12 + c];
    }
    r.alive = 0.0f;
    r.rng = 0u;
    store_ray(r, rt, so, ro);
    return;
  }
  primary(cam, xs[gid], ys[gid], (uint32_t)sample_offset, center != 0, r);
  bounce<CPU>(s, sh, cam, r, s.cand_chunk ? tile : -1);
  store_ray(r, rt, so, ro);
}

// One bounce on packed state.  DIFF (the detached oracle of the
// differentiable integrator, _bounce_step_kernel's diff_out): also write the
// (nt*8, rt) oracle rows [t, u, v, id, vis bits, decision bits, 0, 0], ints
// as exact floats, dead lanes at the defaults; with a binned plan
// (cand_chunk) the closest hit walks the tile's candidates, as emit does.
template <bool CPU, bool DIFF>
__global__ void __launch_bounds__(kThreads)
bounce_step_kernel(SceneArgs s, const float* st_in, const int* rng_in,
                   int n_rays, int rt, float* st_out, int* rng_out,
                   float* diff_out) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;
  const int tile = gid / rt, lane = gid % rt;
  const size_t so = (size_t)tile * kStRows * rt + lane;
  const size_t ro = (size_t)tile * 8 * rt + lane;
  Ray r;
  load_ray(st_in + so, rng_in + ro, rt, r);
  Capture cap;
  if (r.alive > 0.0f)  // dead rays pass
    bounce<CPU, DIFF>(s, sh, s.cam, r, DIFF && s.cand_chunk ? tile : -1,
                      DIFF ? &cap : nullptr);
  store_ray(r, rt, st_out + so, rng_out + ro);
  if (DIFF) {
    float* dv = diff_out + (size_t)tile * 8 * rt + lane;
    dv[0] = cap.t;
    dv[rt] = cap.u;
    dv[2 * rt] = cap.v;
    dv[3 * rt] = (float)cap.id;
    dv[4 * rt] = (float)cap.vis;
    dv[5 * rt] = (float)cap.dec;
    dv[6 * rt] = 0.0f;
    dv[7 * rt] = 0.0f;
  }
}

template <bool CPU>
__global__ void __launch_bounds__(kThreads)
resume_kernel(SceneArgs s, const float* st_in, const int* rng_in, int n_rays,
              int rt, int max_depth, float* r_out, float* g_out,
              float* b_out) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;
  const int tile = gid / rt, lane = gid % rt;
  Ray r;
  load_ray(st_in + (size_t)tile * kStRows * rt + lane,
           rng_in + (size_t)tile * 8 * rt + lane, rt, r);
  for (int depth = 1; depth < max_depth && r.alive > 0.0f; ++depth)
    bounce<CPU>(s, sh, s.cam, r, -1);
  r_out[gid] = r.rd[0];
  g_out[gid] = r.rd[1];
  b_out[gid] = r.rd[2];
}

// The monolithic render (_render_kernel): one thread owns one pixel over
// all spp samples and writes the r, g, b sums.  gpu sky tiles add
// clip(miss) per sample; other rays run depth 0 (binned or flat) and,
// unless terminal, bounces 1..max-1, and add clip(rd) (gpu) or rd
// (cpuonly, no per-sample clamp).
template <bool CPU>
__global__ void __launch_bounds__(kThreads)
render_kernel(SceneArgs s, const int* xs, const int* ys, const int* has_work,
              int n_rays, int rt, int spp, int sample_offset, int center,
              int terminal, int max_depth, float* r_out, float* g_out,
              float* b_out) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;
  const int tile = gid / rt;
  const float* cam = s.cam;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (!CPU && !has_work[tile]) {
    for (int k = 0; k < spp; ++k)
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + clip01(cam[12 + c]);
  } else {
    for (int k = 0; k < spp; ++k) {
      Ray r;
      primary(cam, xs[gid], ys[gid], (uint32_t)(sample_offset + k),
              center != 0, r);
      bounce<CPU>(s, sh, cam, r, s.cand_chunk ? tile : -1);
      if (!terminal)
        for (int depth = 1; depth < max_depth && r.alive > 0.0f; ++depth)
          bounce<CPU>(s, sh, cam, r, -1);
      for (int c = 0; c < 3; ++c)
        acc[c] = acc[c] + (CPU ? r.rd[c] : clip01(r.rd[c]));
    }
  }
  r_out[gid] = acc[0];
  g_out[gid] = acc[1];
  b_out[gid] = acc[2];
}

// The staged integrator's closest hit (E, _closest_kernel): one thread per
// ray runs the flat block scan on [tmin[i], best t]; with_normal adds the
// gpu shading normal (0, 0, 1 on a miss); each of the n_shadow point lights
// then gets the fused IsInShadow walk of _closest_kernel in its op order:
// p = o + t d + n eps, dist = sqrt(max(|to|^2, 1e-38)), direction
// to * (1 / dist), any hit on [shadow_tmin, dist]; lanes that miss or face
// away (N.L <= 0 or N.V <= 0) trace nothing and get visibility 0.  The
// Pallas kernel's superblock plan, early exit and quarter gating are TPU
// schedules: the (t, id) take rule gives the same winners in any order.
// Bound on this card: FP32 Moller-Trumbore per ray-triangle pair, planes
// read from L2; nothing here for the tensor cores.
__global__ void __launch_bounds__(kThreads)
closest_kernel(SceneArgs s, const float* orig, const float* dir,
               const float* tmin, int n_rays, int with_normal,
               const float* shadow_lights, int n_shadow, float* t_out,
               float* u_out, float* v_out, int* idx_out, float* n_out,
               float* vis_out) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;
  const float o[3] = {orig[3 * gid], orig[3 * gid + 1], orig[3 * gid + 2]};
  const float d[3] = {dir[3 * gid], dir[3 * gid + 1], dir[3 * gid + 2]};
  const Hit h = closest(s, sh, o, d, tmin[gid]);
  t_out[gid] = h.t;
  u_out[gid] = h.u;
  v_out[gid] = h.v;
  idx_out[gid] = h.id;
  if (!with_normal) return;
  const bool hit = h.t < kF32Max;
  float n[3] = {0.0f, 0.0f, 1.0f};
  if (hit) shading_normal<false>(s, h, d, n);
  for (int c = 0; c < 3; ++c) n_out[3 * gid + c] = n[c];
  float p[3];
  for (int c = 0; c < 3; ++c)
    p[c] = hit ? o[c] + h.t * d[c] + n[c] * s.shadow_eps : 1e30f;
  const float ndotv = -(n[0] * d[0] + n[1] * d[1] + n[2] * d[2]);
  for (int li = 0; li < n_shadow; ++li) {
    const float* L = shadow_lights + 3 * li;
    const float to[3] = {L[0] - p[0], L[1] - p[1], L[2] - p[2]};
    const float dist =
        sqrtf(fmaxf(to[0] * to[0] + to[1] * to[1] + to[2] * to[2], 1e-38f));
    const float inv_dist = 1.0f / dist;
    const float sd[3] = {to[0] * inv_dist, to[1] * inv_dist, to[2] * inv_dist};
    const float ndotl = n[0] * sd[0] + n[1] * sd[1] + n[2] * sd[2];
    const bool facing = hit && ndotl > 0.0f && ndotv > 0.0f;
    vis_out[(size_t)gid * n_shadow + li] =
        facing && !occluded(s, sh, p, sd, s.shadow_tmin, dist, dist) ? 1.0f
                                                                      : 0.0f;
  }
}

// The staged integrator's any-hit test (F, _occluded_kernel): one thread
// per ray walks the blocks on [tmin[i], tmax[i]] and stops at its first
// blocker.  Bound as closest_kernel.
__global__ void __launch_bounds__(kThreads)
occluded_kernel(SceneArgs s, const float* orig, const float* dir,
                const float* tmin, const float* tmax, int n_rays,
                unsigned char* blocked) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_rays) return;
  const float o[3] = {orig[3 * gid], orig[3 * gid + 1], orig[3 * gid + 2]};
  const float d[3] = {dir[3 * gid], dir[3 * gid + 1], dir[3 * gid + 2]};
  blocked[gid] = occluded(s, sh, o, d, tmin[gid], tmax[gid], tmax[gid]);
}

// ---- C interface (loaded with ctypes) ----

namespace {

size_t shared_bytes(const SceneArgs& s) {
  return sizeof(float) *
         (6 * (size_t)s.num_blocks + 8 * (size_t)s.n_lights +
          16 * (size_t)s.n_objects);
}

template <typename K>
int prepare(K kernel, const SceneArgs& s) {
  size_t smem = shared_bytes(s);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (s.cand_chunk && (!s.cand_meta || !s.cand_stream))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int rt_emit(const SceneArgs* s, const int* xs, const int* ys,
            const int* has_work, int n_rays, int rt, int sample_offset,
            int center, float* st_out, int* rng_out, void* stream) {
  auto kernel = s->cpuonly ? &emit_kernel<true> : &emit_kernel<false>;
  int e = prepare(kernel, *s);
  if (e) return e;
  kernel<<<blocks_for(n_rays), kThreads, shared_bytes(*s),
           (cudaStream_t)stream>>>(*s, xs, ys, has_work, n_rays, rt,
                                   sample_offset, center, st_out, rng_out);
  return (int)cudaGetLastError();
}

// diff_out: nullptr, or the (nt*8, rt) oracle rows (gpu dialect only).
// A binned plan (cand_chunk) is taken only with diff_out.
int rt_bounce_step(const SceneArgs* s, const float* st_in, const int* rng_in,
                   int n_rays, int rt, float* st_out, int* rng_out,
                   float* diff_out, void* stream) {
  if ((diff_out && s->cpuonly) || (s->cand_chunk && !diff_out))
    return (int)cudaErrorInvalidValue;
  auto kernel = s->cpuonly ? &bounce_step_kernel<true, false>
                : diff_out ? &bounce_step_kernel<false, true>
                           : &bounce_step_kernel<false, false>;
  int e = prepare(kernel, *s);
  if (e) return e;
  kernel<<<blocks_for(n_rays), kThreads, shared_bytes(*s),
           (cudaStream_t)stream>>>(*s, st_in, rng_in, n_rays, rt, st_out,
                                   rng_out, diff_out);
  return (int)cudaGetLastError();
}

int rt_resume(const SceneArgs* s, const float* st_in, const int* rng_in,
              int n_rays, int rt, int max_depth, float* r_out, float* g_out,
              float* b_out, void* stream) {
  auto kernel = s->cpuonly ? &resume_kernel<true> : &resume_kernel<false>;
  int e = prepare(kernel, *s);
  if (e) return e;
  kernel<<<blocks_for(n_rays), kThreads, shared_bytes(*s),
           (cudaStream_t)stream>>>(*s, st_in, rng_in, n_rays, rt, max_depth,
                                   r_out, g_out, b_out);
  return (int)cudaGetLastError();
}

int rt_render(const SceneArgs* s, const int* xs, const int* ys,
              const int* has_work, int n_rays, int rt, int spp,
              int sample_offset, int center, int terminal, int max_depth,
              float* r_out, float* g_out, float* b_out, void* stream) {
  auto kernel = s->cpuonly ? &render_kernel<true> : &render_kernel<false>;
  int e = prepare(kernel, *s);
  if (e) return e;
  kernel<<<blocks_for(n_rays), kThreads, shared_bytes(*s),
           (cudaStream_t)stream>>>(*s, xs, ys, has_work, n_rays, rt, spp,
                                   sample_offset, center, terminal,
                                   max_depth, r_out, g_out, b_out);
  return (int)cudaGetLastError();
}

int rt_closest(const SceneArgs* s, const float* orig, const float* dir,
               const float* tmin, int n_rays, int with_normal,
               const float* shadow_lights, int n_shadow, float* t_out,
               float* u_out, float* v_out, int* idx_out, float* n_out,
               float* vis_out, void* stream) {
  int e = prepare(&closest_kernel, *s);
  if (e) return e;
  closest_kernel<<<blocks_for(n_rays), kThreads, shared_bytes(*s),
                   (cudaStream_t)stream>>>(
      *s, orig, dir, tmin, n_rays, with_normal, shadow_lights, n_shadow, t_out,
      u_out, v_out, idx_out, n_out, vis_out);
  return (int)cudaGetLastError();
}

int rt_occluded(const SceneArgs* s, const float* orig, const float* dir,
                const float* tmin, const float* tmax, int n_rays,
                unsigned char* blocked, void* stream) {
  int e = prepare(&occluded_kernel, *s);
  if (e) return e;
  occluded_kernel<<<blocks_for(n_rays), kThreads, shared_bytes(*s),
                    (cudaStream_t)stream>>>(*s, orig, dir, tmin, tmax, n_rays,
                                            blocked);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
