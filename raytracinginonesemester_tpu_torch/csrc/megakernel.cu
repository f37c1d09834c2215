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
// Design.  A thread owns a ray (B: lanes 0-7 of a warp; A's first launch:
// four threads a ray), 128 threads per block.  The owner of ray (tile, lane) reads state row k at
// tile*16*rt + k*rt + lane, so each row load of a warp is coalesced.
// Triangle planes stay in global memory (frog at 512-blocks is ~1.7 MB
// and lives in L2); block AABBs, lights and materials are staged in
// shared memory.  Closest hit either scans blocks 0..L-1 with a per-ray
// slab test against the running best t before each block's triangle loop
// (the per-ray form of the Pallas tile-level gate), or, at depth 0 with a
// binned camera plan (ops/binned.py), walks the tile's candidate chunks.
// The lexicographic (t, global triangle id) take rule makes the winner
// independent of visit order.  Shadow rays stop at their first hit.  The
// hemisphere and disk samplers are the reference's scalar rejection loops
// (query.h:51-71, raytracer.h:77-85), capped at 64 rounds.
//
// The walks, kernel by kernel:
// - emit (A), three launches: emit_kernel finds the closest hits (a CTA
//   lies in one tile; a tile without work writes its dead rows before it
//   stages anything; the binned walk reads the tile's chunks from shared
//   memory, double-buffered with cp.async, split over four threads a ray,
//   closest_binned_cta; the flat walk is closest_coop, 8 rays a warp),
//   keeps them and lists the shadow rays that pass a slab test; emit_walk_kernel, a grid that fills the card, walks the
//   list kListRays rays a warp (occluded_coop); emit_finish_kernel shades
//   with the flags.
// - bounce_step (B): the flat closest hit and the shadow rays are
//   warp-cooperative, 8 rays to a warp (closest_coop, occluded_coop); its
//   binned oracle depth 0 keeps a lane's own binned walk, 32 rays a warp.
// - occluded (F), two launches: the rays that pass a slab test are
//   listed, and the list is walked as emit's is.
// - render (D): kRenderSplit threads a pixel over its samples; depth 0
//   with a binned plan reads the tile's chunks staged by the CTA, split
//   over the path's threads (closest_binned_cta), the flat walks and the
//   shadow rays are warp-cooperative, 8 paths a warp (bounce<..,
//   kRender>).
// - resume (C): bounce_step's walks (bounce<.., kWarp>), kResumeRays rays
//   a warp, the depth loop running while a ray of the warp lives.
// - closest (E), three launches: a ray a thread writes the miss of a ray
//   whose slab test passes no block and lists the others;
//   closest_walk_kernel, a grid that fills the card, walks the list
//   kRaysPerWarp rays a warp (fewer when it is short; closest_coop),
//   shades the hits and lists
//   the facing (ray, light) entries that pass a slab test;
//   closest_shadow_kernel walks that list as emit's is walked.
//
// What bounds it on this card: divergent scalar FP32 work (Moller-Trumbore
// per ray-triangle pair, shadow walks, rejection sampling) and the latency
// of L2-resident triangle reads that wait on each other; there is nothing
// matrix-shaped for the tensor cores.  The cooperative walks make each
// (ray, block) pair's 512 tests independent and coalesced; the shadow
// lists spread the rays that must walk, which lie together in a few
// tiles, over the whole card.  The kernels keep the JAX kernels' op order
// (built with -fmad=false and IEEE div/sqrt), so that they can be held
// against them to the last ulp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

constexpr int kStRows = 16;
constexpr int kCandRows = 16;
// rows 0-11 of a candidate chunk (9 planes, id, home, slot), the ones
// emit stages in shared memory
constexpr int kStageRows = 12;
constexpr int kThreads = 128;
constexpr float kInvPi = 0.31830988618f;
constexpr float kInv2Pi = 0.15915494309f;
constexpr unsigned kFull = 0xffffffffu;
// rays a warp of bounce_step_kernel owns when its closest hit is the flat
// walk; its 32 lanes test their pairs
constexpr int kRaysPerWarp = 8;
// entries of a shadow list a warp takes at a time (walk_list; measured:
// 2, 4 and 8 within the noise of each other, 16 slower), fewer when the
// list is short (take_groups)
constexpr int kListRays = 4;
// rays a warp of resume_kernel owns (measured on the frog's overflow
// state: 4 rays a warp 31% faster than 8; on cpuonly_mirror's 2% slower)
constexpr int kResumeRays = 4;
// threads of emit_kernel a ray has: they split its closest walk
constexpr int kEmitSplit = 4;
// threads of render_kernel a path has: they split its binned depth 0, and
// the path's first thread walks it after that, 8 paths a warp (measured:
// 32 and 16 paths a warp 1.3-2.1x slower on the frog, 8 within 5% of 16
// on cpuonly_mirror)
constexpr int kRenderSplit = 4;

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
  float* chunks;        // emit, binned: two (kStageRows, C) chunk buffers
};

// How bounce() walks: the lanes of a warp together (kWarp: bounce_step,
// resume), or emit's three launches: the CTA
// finds its closest hits together and lists its shadow rays (kList), a
// listed walk's ray is made again to be walked (kCapture), and the flags
// of the walks are read back to shade (kFlags); the render (kRender) walks
// as kWarp does, but a binned depth 0 reads the chunks the CTA stages.
enum Walk { kWarp, kList, kCapture, kFlags, kRender };

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

// slab(), mt(), Hit and take() are in trace_common.cuh.

// The oracle rows of one bounce (bounce_step_tiles(diff_out=True)): the
// winner's t, u, v and global id, the per-light visibility bits and the
// decision bits (1 found, 2 diffuse, 4 mirror, 8 alive after).  The
// defaults are a dead lane's.
struct Capture {
  float t = kF32Max, u = 0.0f, v = 0.0f;
  int id = -1, vis = 0, dec = 0;
};

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

// The lexicographic (t, id, j) order; misses carry (kF32Max, kIntMax, j).
__device__ __forceinline__ bool key_less(float t, int id, int j, float t2,
                                         int id2, int j2) {
  return t < t2 || (t == t2 && (id < id2 || (id == id2 && j < j2)));
}

// ---- emit's binned walk: the tile's chunks from shared memory ----
//
// Every thread of a CTA of emit lies in one tile, so all of them walk the
// same chunks.  The CTA copies chunk c + 1's rows 0-11 into one buffer
// (cp.async, 16 bytes a thread and copy) while its threads test chunk c
// from the other; each thread then tests four candidates at the window
// its running best t had before them and takes them in order.  That is
// the sequential walk's winner: mt() computes t, u and v from the same
// inputs whatever the window, and a t the wider window lets through but
// the shrunken one would not is larger than the best t that shrank it,
// which the take rule then keeps.

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk c's rows 0-11 into dst, as one cp.async group (plain copies when
// the chunk width or the stream's address does not allow 16-byte ones).
__device__ void stage_chunk(const SceneArgs& s, int c, float* dst) {
  const int words = kStageRows * s.cand_chunk;
  const float* src = s.cand_stream + (size_t)c * kCandRows * s.cand_chunk;
  if (s.cand_chunk % 4 == 0 && ((uintptr_t)s.cand_stream & 15) == 0) {
    for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  cp_async_commit();
}

// closest_binned() for the threads of a CTA together (every thread calls
// it), SPLIT neighbouring threads a ray (emit: kEmitSplit; the render:
// kRenderSplit): thread `sub` of a ray tests the groups of four
// candidates g with g % SPLIT == sub (and the singles that end a chunk of
// a width that is not a multiple of 4, in the same turn), and the threads
// of the ray end with the first (t, id) minimum in walk order, the
// sequential walk's winner (the take rule keeps a later equal (t, id)
// out).
template <int SPLIT>
__device__ Hit closest_binned_cta(const SceneArgs& s, const Shared& sh,
                                  int tile, const float* o, const float* d) {
  const int c_w = s.cand_chunk;
  const int first = s.cand_meta[8 * tile];
  const int count = s.cand_meta[8 * tile + 1];
  const int words = kStageRows * c_w;
  const int sub = threadIdx.x % SPLIT;
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  int pos = kIntMax;  // the taken candidate's place in walk order
  if (count > 0) stage_chunk(s, first, sh.chunks);
  for (int c = 0; c < count; ++c) {
    const float* rows = sh.chunks + (c & 1) * words;
    if (c + 1 < count) {
      stage_chunk(s, first + c + 1, sh.chunks + ((c + 1) & 1) * words);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is in
    const int quads = c_w / 4 * 4;
    for (int j = 4 * sub; j < quads; j += 4 * SPLIT) {
      const float window = h.t;
      float t[4], u[4], v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        t[q] = mt(rows + j + q, c_w, s.det_eps, o, d, s.tmin, window, &u[q],
                  &v[q]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int id = (int)rows[9 * c_w + j + q];  // exact integers in f32
        const Hit was = h;
        if (id >= 0)
          take(h, t[q], u[q], v[q], id, (int)rows[11 * c_w + j + q]);
        if (h.id != was.id || h.t != was.t) pos = c * c_w + j + q;
      }
    }
    for (int j = quads + sub; j < c_w; j += SPLIT) {
      const int id = (int)rows[9 * c_w + j];
      if (id < 0) continue;
      float u, v;
      const float t = mt(rows + j, c_w, s.det_eps, o, d, s.tmin, h.t, &u, &v);
      const Hit was = h;
      take(h, t, u, v, id, (int)rows[11 * c_w + j]);
      if (h.id != was.id || h.t != was.t) pos = c * c_w + j;
    }
    __syncthreads();  // chunk c's buffer is free for chunk c + 2
  }
  // the ray's threads are SPLIT neighbouring lanes: a xor tree
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
    const float ot = __shfl_xor_sync(kFull, h.t, off);
    const float ou = __shfl_xor_sync(kFull, h.u, off);
    const float ov = __shfl_xor_sync(kFull, h.v, off);
    const int oid = __shfl_xor_sync(kFull, h.id, off);
    const int ok = __shfl_xor_sync(kFull, h.k, off);
    const int opos = __shfl_xor_sync(kFull, pos, off);
    if (key_less(ot, oid >= 0 ? oid : kIntMax, opos, h.t,
                 h.id >= 0 ? h.id : kIntMax, pos)) {
      h = Hit{ot, ou, ov, oid, ok};
      pos = opos;
    }
  }
  return h;
}

// The hit of a walk every thread of the CTA made, kept by `live` lanes
// (the render: a path's other threads go on with a miss).
__device__ __forceinline__ Hit cta_hit(const Hit& h, bool live) {
  return live ? h : Hit{kF32Max, 0.0f, 0.0f, -1, 0};
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

// ---- the warp-cooperative walks ----
//
// The closest hit is the flat block scan: blocks 0..L-1 in order, each
// gated by the ray's slab test on [tmin, best t], its triangles taken by
// the (t, id) rule; the any-hit walk gates them on [tmin, dist], tests
// the triangles on [tmin, tmax] and stops at the first blocker.
// Measured on the card (scripts/profile_torch_main_path.py --kernels):
// walked by one thread a ray, a warp runs a block's 512-step triangle
// loop whenever any of its lanes passes the block's slab test (half its
// lanes idle after a diffuse bounce), and each step is one triangle whose
// test waits on the step before (the window shrinks with the running
// best t), with few live warps to hide that.
//
// Here each lane keeps its ray, running hit and block cursor, and gates
// the blocks in order against its running best t as that scan does.  The
// warp takes the lowest block any lane waits on, and
// all 32 lanes test the (ray, block) pairs waiting on it one after the
// other, lane l taking triangles l, l + 32, ... (coalesced plane loads,
// and independent tests: the window is the owner's best t when the block
// starts).  A fixed shuffle tree keeps the lexicographic (t, global id,
// slot) minimum, which the owner takes by the take rule.  That is the
// winner of the sequential walk: a triangle it rejects for the shrunken
// window has a larger t than the hit that shrank it, and mt() computes
// t, u and v from the same inputs in both.  Every lane of the warp calls
// these; `active` marks the lanes that have a ray to walk.  A warp owns
// kRaysPerWarp rays: with 32 the few warps holding the live rays of a
// bounce kept the card busy half the time (the slowest warps set the
// time), with 8 there are four times as many, each with a quarter of the
// pairs.  (The binned walk, one ray a lane, keeps 32.)

// The first block from b on whose slab test passes on [t0, t1] (L: none).
__device__ __forceinline__ int next_block(const SceneArgs& s,
                                          const Shared& sh, const float* o,
                                          const float* inv, float t0,
                                          float t1, int b) {
  while (b < s.num_blocks && !slab(sh.aabb + 6 * b, o, inv, t0, t1)) ++b;
  return b;
}

// All 32 lanes test the pair's block (ray o, d on [tmin, tmax]) and end
// with its closest triangle, the same on every lane: slot j in the block
// (kIntMax if none), t (kF32Max), u, v and global id.
__device__ void block_closest_warp(const SceneArgs& s, int b, const float* o,
                                   const float* d, float tmin, float tmax,
                                   float* t_o, float* u_o, float* v_o,
                                   int* id_o, int* j_o) {
  const int lane = threadIdx.x & 31;
  const size_t plane = (size_t)s.num_blocks * s.block_size;
  const int base = b * s.block_size;
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bid = kIntMax, bj = kIntMax;
#pragma unroll 4
  for (int j = lane; j < s.block_size; j += 32) {
    const int id = s.ids[base + j];
    float u, v;
    const float t =
        mt(s.tri + base + j, plane, s.det_eps, o, d, tmin, tmax, &u, &v);
    // ascending j within the lane: a tie keeps the earlier slot
    if (id >= 0 && t < kF32Max && (t < bt || (t == bt && id < bid))) {
      bt = t;
      bu = u;
      bv = v;
      bid = id;
      bj = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, bt, off);
    const int oid = __shfl_xor_sync(kFull, bid, off);
    const int oj = __shfl_xor_sync(kFull, bj, off);
    if (key_less(ot, oid, oj, bt, bid, bj)) {
      bt = ot;
      bid = oid;
      bj = oj;
    }
  }
  const int src = bj == kIntMax ? 0 : (bj & 31);  // the winner's lane
  *u_o = __shfl_sync(kFull, bu, src);
  *v_o = __shfl_sync(kFull, bv, src);
  *t_o = bt;
  *id_o = bid;
  *j_o = bj;
}

// The closest hit of each active lane's ray, for the lanes of a warp
// together.
__device__ Hit closest_coop(const SceneArgs& s, const Shared& sh,
                            const float* o, const float* d, float tmin,
                            bool active) {
  const int lane = threadIdx.x & 31;
  const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  int b = active ? next_block(s, sh, o, inv, tmin, h.t, 0) : s.num_blocks;
  for (int bmin = __reduce_min_sync(kFull, b); bmin < s.num_blocks;
       bmin = __reduce_min_sync(kFull, b)) {
    for (unsigned todo = __ballot_sync(kFull, b == bmin); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      float po[3], pd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        po[c] = __shfl_sync(kFull, o[c], src);
        pd[c] = __shfl_sync(kFull, d[c], src);
      }
      const float ptmin = __shfl_sync(kFull, tmin, src);
      const float ptmax = __shfl_sync(kFull, h.t, src);
      float t, u, v;
      int id, j;
      block_closest_warp(s, bmin, po, pd, ptmin, ptmax, &t, &u, &v, &id, &j);
      if (lane == src && j != kIntMax)
        take(h, t, u, v, id, bmin * s.block_size + j);
    }
    if (b == bmin) b = next_block(s, sh, o, inv, tmin, h.t, b + 1);
  }
  return h;
}

// Any hit of the pair's block on [tmin, tmax], on every lane; the lanes
// test 128 triangles between votes.
__device__ bool block_any_warp(const SceneArgs& s, int b, const float* p,
                               const float* ld, float tmin, float tmax) {
  const int lane = threadIdx.x & 31;
  const size_t plane = (size_t)s.num_blocks * s.block_size;
  const int base = b * s.block_size;
  for (int j0 = 0; j0 < s.block_size; j0 += 128) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 32 * q + lane;
      if (j < s.block_size && s.ids[base + j] >= 0) {
        float u, v;
        hit |= mt(s.tri + base + j, plane, s.det_eps, p, ld, tmin, tmax, &u,
                  &v) < kF32Max;
      }
    }
    if (__any_sync(kFull, hit)) return true;
  }
  return false;
}

// Any hit (IsInShadow) of each active lane's ray, for the lanes of a warp
// together: a lane leaves the walk at the first block that holds a
// blocker.
__device__ bool occluded_coop(const SceneArgs& s, const Shared& sh,
                              const float* p, const float* ld, float tmin,
                              float dist, float tmax, bool active) {
  const int lane = threadIdx.x & 31;
  const float inv[3] = {1.0f / ld[0], 1.0f / ld[1], 1.0f / ld[2]};
  bool blocked = false;
  int b = active ? next_block(s, sh, p, inv, tmin, dist, 0) : s.num_blocks;
  for (int bmin = __reduce_min_sync(kFull, b); bmin < s.num_blocks;
       bmin = __reduce_min_sync(kFull, b)) {
    for (unsigned todo = __ballot_sync(kFull, b == bmin); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      float pp[3], pl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pp[c] = __shfl_sync(kFull, p[c], src);
        pl[c] = __shfl_sync(kFull, ld[c], src);
      }
      const float ptmin = __shfl_sync(kFull, tmin, src);
      const float ptmax = __shfl_sync(kFull, tmax, src);
      if (block_any_warp(s, bmin, pp, pl, ptmin, ptmax) && lane == src)
        blocked = true;
    }
    if (b == bmin)
      b = blocked ? s.num_blocks : next_block(s, sh, p, inv, tmin, dist, b + 1);
  }
  return blocked;
}

// ---- shadow lists: the walks of A and F spread over the whole card ----
//
// Measured (scripts/profile_torch_main_path.py --kernels): a ray's shadow
// walk tests 1 to 16 blocks (3.3 on the headline's facing rays), and the
// rays that test many lie together, in a few CTAs; walked where their
// CTA lies, the warps holding them set the kernel's time.  So the rays
// that must walk (some block's slab test passes) are listed in device
// memory, one atomicAdd a CTA, and a grid that fills the card walks the
// list: each warp takes the next kListRays entries (one atomicAdd) and
// walks them with occluded_coop until the list is done.  The flags come
// out the same in any order: each ray's walk is its own.

// The list of a launch: `counts` [0] entries, [1] groups taken (both 0
// before the listing launch); entry e = gid * rounds + round, its flag at
// flags[e] (1: blocked).  emit (A) keeps each ray's closest hit in `hits`
// (5 planes of n_rays: t, u, v, and the bits of id and slot) between its
// launches; F's flags are its output.
struct Shadows {
  int* counts;
  int* list;
  unsigned char* flags;
  float* hits;
  int rounds;  // walks a ray may make (A: a light's or each disk sample's)
  int n_rays;
};

// Append the entries of the CTA's threads that `want` to the list (every
// thread of the CTA calls it): one atomicAdd reserves their places.
__device__ void list_append(const Shadows& q, bool want, int entry) {
  __shared__ int l_count[kThreads / 32];
  __shared__ int l_base;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(kFull, want);
  if (lane == 0) l_count[w] = __popc(ball);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int n = l_count[k];
    off += k < w ? n : 0;
    total += n;
  }
  if (threadIdx.x == 0) l_base = total ? atomicAdd(&q.counts[0], total) : 0;
  __syncthreads();
  if (want) q.list[l_base + off + __popc(ball & ((1u << lane) - 1u))] = entry;
}

// A list-walking launch: its warps take groups of the list's entries
// (one atomicAdd a group) until the list is done, and call
// `walk(entry, active)` on every lane, the group's entries on its first
// lanes (`active`).  A group is `most` entries, or fewer when the list
// would not give each warp of the grid one: a short list's few warps
// would walk their entries one pair after another while the others idle.
// Each entry's walk is its own, so the grouping changes no result.
template <class Body>
__device__ void take_groups(const Shadows& q, int most, Body walk) {
  const int lane = threadIdx.x & 31;
  const int total = q.counts[0];
  const int warps = gridDim.x * (blockDim.x / 32);
  int n = most;
  while (n > 1 && n * warps > total) n >>= 1;
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(&q.counts[1], 1);
    const int e0 = __shfl_sync(kFull, g, 0) * n;
    if (e0 >= total) return;
    const int e = e0 + lane;
    const bool active = lane < n && e < total;
    walk(active ? q.list[e] : 0, active);
  }
}

// The shadow walk of a list, kListRays entries a group: `ray_of(entry,
// row)` fills an entry's row (p, ld, tmin, dist, tmax) on its lane, the
// warp walks the group, and `mark(entry)` records a blocked entry.
template <class RayOf, class Mark>
__device__ void walk_list(const SceneArgs& s, const Shared& sh,
                          const Shadows& q, RayOf ray_of, Mark mark) {
  take_groups(q, kListRays, [&](int entry, bool active) {
    float row[9] = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f, 0.0f, 0.0f};
    if (active) ray_of(entry, row);
    if (occluded_coop(s, sh, row, row + 3, row[6], row[7], row[8], active) &&
        active)
      mark(entry);
  });
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

// A ray's place in emit's launches: its shadow walks counted in the one
// order all three make them (a light's walk, or each of its disk
// samples'), and, kCapture, the walk whose ray is wanted.
struct ShadowCtx {
  Shadows q;
  int gid;     // the ray
  int round;   // the walk about to be made
  int target;  // kCapture: the walk to capture
  float ray[9];  // kCapture: its p, ld, tmin, dist, tmax
  bool owner = true;  // kList: the one of the ray's threads that writes
};

__device__ __forceinline__ void store_hit(const Shadows& q, int gid,
                                          const Hit& h) {
  const size_t n = q.n_rays;
  q.hits[gid] = h.t;
  q.hits[n + gid] = h.u;
  q.hits[2 * n + gid] = h.v;
  q.hits[3 * n + gid] = __int_as_float(h.id);
  q.hits[4 * n + gid] = __int_as_float(h.k);
}

__device__ __forceinline__ Hit load_hit(const Shadows& q, int gid) {
  const size_t n = q.n_rays;
  return Hit{q.hits[gid], q.hits[n + gid], q.hits[2 * n + gid],
             __float_as_int(q.hits[3 * n + gid]),
             __float_as_int(q.hits[4 * n + gid])};
}

// The any-hit walk of a facing ray, as W makes it (every lane or thread
// calls it): kWarp and kRender, the warp walks it; kList, a ray
// one of whose slab tests passes is listed, its flag cleared, and the
// walk reads as unblocked; kCapture keeps the wanted walk's ray; kFlags
// reads the walk's flag.
template <Walk W>
__device__ bool walk_occluded(const SceneArgs& s, const Shared& sh,
                              const float* p, const float* ld, float tmin,
                              float dist, float tmax, bool facing,
                              ShadowCtx* c) {
  if constexpr (W == kWarp || W == kRender) {
    return occluded_coop(s, sh, p, ld, tmin, dist, tmax, facing);
  } else {
    const int entry = c->gid * c->q.rounds + c->round;
    bool blocked = false;
    if constexpr (W == kList) {
      const float inv[3] = {1.0f / ld[0], 1.0f / ld[1], 1.0f / ld[2]};
      const bool listed = c->owner && facing &&
                          next_block(s, sh, p, inv, tmin, dist, 0) <
                              s.num_blocks;
      if (c->owner) c->q.flags[entry] = 0;
      list_append(c->q, listed, entry);
    } else if constexpr (W == kCapture) {
      if (c->round == c->target) {
        const float row[9] = {p[0],  p[1], p[2], ld[0], ld[1],
                              ld[2], tmin, dist, tmax};
        for (int k = 0; k < 9; ++k) c->ray[k] = row[k];
      }
    } else {
      blocked = facing && c->q.flags[entry] != 0;
    }
    ++c->round;
    return blocked;
  }
}

// One cpuonly shadow walk from p along st (not normalised): 1 if nothing
// blocks [shadow_tmin, |st| - shadow_eps], else 0.  Every lane or thread
// calls it.
template <Walk W>
__device__ float soft_walk(const SceneArgs& s, const Shared& sh,
                           const float* p, float stx, float sty, float stz,
                           bool facing, ShadowCtx* c) {
  float d_s = sqrtf(fmaxf(stx * stx + sty * sty + stz * stz, 1e-24f));
  float inv_s = 1.0f / d_s;
  float sld[3] = {stx * inv_s, sty * inv_s, stz * inv_s};
  return walk_occluded<W>(s, sh, p, sld, s.shadow_tmin, d_s,
                          d_s - s.shadow_eps, facing, c)
             ? 0.0f
             : 1.0f;
}

// ShadowVisibility (CPUOnly/raytracer.h:121-168): shadow_samples walks
// toward disk samples of an area light (the draws advance the ray's rng),
// one toward a point light's center.  Every lane or thread calls it, the
// draws advancing the rng of those that hit.
template <Walk W>
__device__ float soft_visibility(const SceneArgs& s, const Shared& sh,
                                 const float* L, const float* p,
                                 const float* to, const float* ld,
                                 bool facing, bool hit, uint32_t* rng,
                                 ShadowCtx* c) {
  const float radius = L[6];
  if (!(radius > 0.0f))
    return soft_walk<W>(s, sh, p, to[0], to[1], to[2], facing, c) / 1.0f;
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
    float dxs = 0.0f, dys = 0.0f;
    if (hit) disk_sample(rng, &dxs, &dys);
    const float spx = L[0] + (tx * dxs + bx * dys) * radius;
    const float spy = L[1] + (ty * dxs + by * dys) * radius;
    const float spz = L[2] + (tz * dxs + bz * dys) * radius;
    unocc = unocc + soft_walk<W>(s, sh, p, spx - p[0], spy - p[1],
                                 spz - p[2], facing, c);
  }
  return unocc / (float)s.shadow_samples;
}

// One closest hit + direct light + Russian-roulette step on an alive ray
// (the loop body of TraceRayIterative, query.h:165-216, or of CPUOnly's
// TraceRay).  tile >= 0: closest hit walks that tile's binned candidates.
// DIFF (gpu dialect only): also fill *cap with the oracle rows; the other
// instantiations compile without it.  W = kWarp: every lane of the warp
// calls it, the flat closest hit and the shadow rays take the
// warp-cooperative walks, and `live` marks the lanes whose ray bounces
// (the others find no hit, trace nothing, and the caller drops what they
// computed).  W = kList: every thread of the CTA calls it, kEmitSplit
// threads a live ray (*c: its place; `live`: c->owner); the binned walk
// reads the chunks the CTA stages, split over the ray's threads, the flat
// one is the warp-cooperative walk of the owners, 8 a warp; all of the
// ray's threads end with its hit, and its owner keeps the hit and lists
// the shadow rays; the bounce ends after the lights.  kCapture: the hit
// read back, the bounce ends after the lights with the wanted walk's ray
// in c->ray.  kFlags: the hit read back, the walks' flags read.  kRender:
// as kWarp, but with a binned plan every thread of the CTA calls it and
// reads the chunks the CTA stages, kRenderSplit threads a ray, of which
// `live` marks the one that goes on with the hit.
template <bool CPU, bool DIFF, Walk W>
__device__ void bounce(const SceneArgs& s, const Shared& sh, const float* cam,
                       Ray& r, int tile, Capture* cap = nullptr,
                       bool live = true, ShadowCtx* c = nullptr) {
  const float* o = r.bo;
  const float* d = r.bd;
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  if constexpr (W == kCapture || W == kFlags) {
    h = load_hit(c->q, c->gid);
  } else if (tile >= 0) {
    if constexpr (W == kList)
      h = closest_binned_cta<kEmitSplit>(s, sh, tile, o, d);
    else if constexpr (W == kRender)
      h = cta_hit(closest_binned_cta<kRenderSplit>(s, sh, tile, o, d), live);
    else if (live)
      h = closest_binned(s, tile, o, d);
  } else {
    h = closest_coop(s, sh, o, d, s.tmin, live);
  }
  if constexpr (W == kList) {
    if (tile < 0) {  // the owner's flat walk, to the ray's other threads
      const int src = (threadIdx.x & 31) & ~(kEmitSplit - 1);
      h = Hit{__shfl_sync(kFull, h.t, src), __shfl_sync(kFull, h.u, src),
              __shfl_sync(kFull, h.v, src), __shfl_sync(kFull, h.id, src),
              __shfl_sync(kFull, h.k, src)};
    }
    if (c->owner) store_hit(c->q, c->gid, h);
  }
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
    float vis = 1.0f;
    if constexpr (CPU)  // every lane walks; a miss draws nothing
      vis = soft_visibility<W>(s, sh, L, p, to, ld, facing, hit, &r.rng, c);
    if (CPU && !hit) continue;  // a miss adds nothing
    bool blocked = false;
    if constexpr (!CPU)
      blocked = walk_occluded<W>(s, sh, p, ld, s.shadow_tmin, dist, dist,
                                 facing, c);
    if (!facing) continue;  // scale == 0: adds exactly 0
    if (!CPU) vis = blocked ? 0.0f : 1.0f;
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
  if constexpr (W == kList || W == kCapture) return;

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

// Block AABBs, lights and materials into the dynamic shared memory (and,
// `chunks`, the place of emit's two chunk buffers after them, 16-byte
// aligned; emit_shared_bytes() sizes it).
__device__ Shared stage_shared(const SceneArgs& s, bool chunks = false) {
  extern __shared__ __align__(16) float smem[];
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
  float* buf = nullptr;
  if (chunks) {
    const size_t used = 6 * (size_t)s.num_blocks + 8 * (size_t)s.n_lights +
                        16 * (size_t)s.n_objects;
    buf = smem + (used + 3) / 4 * 4;
  }
  return Shared{aabb, lights, mats, buf};
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

// Depth 0 (_emit_kernel), the first of emit's three launches (rt_emit):
// kEmitSplit threads a ray.  rt and n_rays are multiples of a CTA's rays
// (rt_emit checks), so a CTA lies in one tile and every ray of a tile
// with work is alive: the CTA finds its closest hits together, keeps them
// and lists its shadow rays (bounce<.., kList>).  A CTA of a tile without
// work writes its dead rows before it stages anything, and is done.
template <bool CPU>
__global__ void __launch_bounds__(kThreads)
emit_kernel(SceneArgs s, const int* xs, const int* ys, const int* has_work,
            int n_rays, int rt, int sample_offset, int center, float* st_out,
            int* rng_out, Shadows q) {
  const int thread = blockIdx.x * kThreads + threadIdx.x;
  const int gid = thread / kEmitSplit;
  const bool owner = thread % kEmitSplit == 0;
  const int tile = gid / rt, lane = gid % rt;
  const float* cam = s.cam;
  Ray r;
  if (!has_work[tile]) {  // CTA-uniform
    if (!owner) return;
    // no ray of this tile can hit: dead, unit direction, miss radiance
    for (int c = 0; c < 3; ++c) {
      r.bo[c] = 0.0f;
      r.bd[c] = c == 2 ? 1.0f : 0.0f;
      r.tp[c] = 0.0f;
      r.rd[c] = cam[12 + c];
    }
    r.alive = 0.0f;
    r.rng = 0u;
    store_ray(r, rt, st_out + (size_t)tile * kStRows * rt + lane,
              rng_out + (size_t)tile * 8 * rt + lane);
    return;
  }
  const Shared sh = stage_shared(s, s.cand_chunk != 0);
  primary(cam, xs[gid], ys[gid], (uint32_t)sample_offset, center != 0, r);
  ShadowCtx c{q, gid, 0, -1, {}, owner};
  bounce<CPU, false, kList>(s, sh, cam, r, s.cand_chunk ? tile : -1, nullptr,
                            owner, &c);
}

// emit's second launch: a grid that fills the card walks the shadow list.
// A listed walk's ray is made again from the ray's pixel and kept hit
// (bounce<.., kCapture>, which stops after the lights).
template <bool CPU>
__global__ void __launch_bounds__(kThreads)
emit_walk_kernel(SceneArgs s, const int* xs, const int* ys,
                 int sample_offset, int center, Shadows q) {
  const Shared sh = stage_shared(s);
  walk_list(s, sh, q, [&](int entry, float* row) {
    const int gid = entry / q.rounds;
    Ray r;
    primary(s.cam, xs[gid], ys[gid], (uint32_t)sample_offset, center != 0, r);
    ShadowCtx c{q, gid, 0, entry % q.rounds, {}};
    bounce<CPU, false, kCapture>(s, sh, s.cam, r, -1, nullptr, true, &c);
    for (int k = 0; k < 9; ++k) row[k] = c.ray[k];
  }, [&](int entry) { q.flags[entry] = 1; });
}

// emit's last launch: each ray of a tile with work shades its kept hit
// with its walks' flags (bounce<.., kFlags>) and stores its state.
template <bool CPU>
__global__ void __launch_bounds__(kThreads)
emit_finish_kernel(SceneArgs s, const int* xs, const int* ys,
                   const int* has_work, int rt, int sample_offset, int center,
                   float* st_out, int* rng_out, Shadows q) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int tile = gid / rt, lane = gid % rt;
  if (!has_work[tile]) return;  // CTA-uniform: emit_kernel stored it
  const Shared sh = stage_shared(s);
  Ray r;
  primary(s.cam, xs[gid], ys[gid], (uint32_t)sample_offset, center != 0, r);
  ShadowCtx c{q, gid, 0, -1, {}};
  bounce<CPU, false, kFlags>(s, sh, s.cam, r, -1, nullptr, true, &c);
  store_ray(r, rt, st_out + (size_t)tile * kStRows * rt + lane,
            rng_out + (size_t)tile * 8 * rt + lane);
}

// One bounce on packed state.  DIFF (the detached oracle of the
// differentiable integrator, _bounce_step_kernel's diff_out): also write the
// (nt*8, rt) oracle rows [t, u, v, id, vis bits, decision bits, 0, 0], ints
// as exact floats, dead lanes at the defaults; with a binned plan
// (cand_chunk) the closest hit walks the tile's candidates, as emit does.
// The walks are warp-cooperative: lane l < RAYS of warp w owns ray
// w * RAYS + l, and every lane, with a ray or without, tests the live
// rays' blocks.  A warp without a live ray skips the bounce.  Each ray
// stores what it did before (a dead ray unchanged, the defaults in its
// oracle rows).  RAYS is kRaysPerWarp, or 32 with the binned walk, whose
// lanes each walk their own ray's candidates (no lane is left idle).
template <bool CPU, bool DIFF, int RAYS>
__global__ void __launch_bounds__(kThreads)
bounce_step_kernel(SceneArgs s, const float* st_in, const int* rng_in,
                   int n_rays, int rt, float* st_out, int* rng_out,
                   float* diff_out) {
  const Shared sh = stage_shared(s);
  const int wl = threadIdx.x & 31;
  const int gid = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * RAYS + wl;
  const bool in_range = wl < RAYS && gid < n_rays;
  const int tile = gid / rt, lane = gid % rt;
  const size_t so = (size_t)tile * kStRows * rt + lane;
  const size_t ro = (size_t)tile * 8 * rt + lane;
  Ray r{};
  if (in_range) load_ray(st_in + so, rng_in + ro, rt, r);
  const bool live = in_range && r.alive > 0.0f;  // dead rays pass
  Capture cap;
  if (__any_sync(kFull, live)) {  // warp-uniform
    Ray w = r;
    Capture c;
    bounce<CPU, DIFF, kWarp>(s, sh, s.cam, w,
                             DIFF && s.cand_chunk ? tile : -1,
                             DIFF ? &c : nullptr, live);
    if (live) {
      r = w;
      cap = c;
    }
  }
  if (!in_range) return;
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

// The overflow resume (_resume_kernel): bounces 1..max_depth-1 of each
// ray from its state rows, then its radiance.  Measured first
// (scripts/profile_torch_main_path.py --staged): as first ported, one
// thread a ray walking alone, the warps whose rays bounce longest,
// walking a block's 512 triangles one a step, set the time.  The rays now
// walk as bounce_step's do (bounce<.., kWarp>): lane l < RAYS of warp w
// owns ray w * RAYS + l, a (ray, block) pair's triangles are tested on
// the warp's 32 lanes, and the depth loop runs while a ray of the warp
// lives; a lane without a live ray passes live = false, still tests the
// others' pairs, and keeps its state.
template <bool CPU, int RAYS>
__global__ void __launch_bounds__(kThreads)
resume_kernel(SceneArgs s, const float* st_in, const int* rng_in, int n_rays,
              int rt, int max_depth, float* r_out, float* g_out,
              float* b_out) {
  const Shared sh = stage_shared(s);
  const int wl = threadIdx.x & 31;
  const int gid = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * RAYS + wl;
  const bool in_range = wl < RAYS && gid < n_rays;
  const int tile = gid / rt, lane = gid % rt;
  Ray r{};
  if (in_range)
    load_ray(st_in + (size_t)tile * kStRows * rt + lane,
             rng_in + (size_t)tile * 8 * rt + lane, rt, r);
  bool live = in_range && r.alive > 0.0f;
  for (int depth = 1; depth < max_depth && __any_sync(kFull, live);
       ++depth) {
    Ray w = r;
    bounce<CPU, false, kWarp>(s, sh, s.cam, w, -1, nullptr, live);
    if (live) r = w;
    live = live && r.alive > 0.0f;
  }
  if (!in_range) return;
  r_out[gid] = r.rd[0];
  g_out[gid] = r.rd[1];
  b_out[gid] = r.rd[2];
}

// The monolithic render (_render_kernel): kRenderSplit neighbouring
// threads own a pixel over all spp samples, and its first thread writes
// the r, g, b sums; rt is a multiple of a CTA's pixels (rt_render
// checks), so a CTA lies in one tile.  gpu sky tiles add clip(miss) per
// sample.  Every other pixel runs depth 0 (binned or flat) and, unless
// terminal, bounces 1..max-1, and adds clip(rd) (gpu) or rd (cpuonly, no
// per-sample clamp), the samples in ascending order.
//
// Measured first (scripts/profile_torch_main_path.py --render, H100 80GB
// HBM3, 700 W, the 1080p frog at depth 8, binned): as first ported, one
// thread a pixel walking alone, the closest-hit walks took 0.76 of a
// warp's cycles and the light loops 0.24 (0.67 in the terminal frog), the
// rest of the bounces 0.00; the 872 CTAs with work ended at 4.95 ms on
// average and the last at 41.5 (8.4x; the terminal frog 3.9x, cpuonly
// 9.1x): the warps holding the paths that bounce longest, walking a
// block's 512 triangles one a step, set the time.  A warp's loop ran
// 2.52 depths against its lanes' 1.69, but the lanes of dead paths cost
// only the walks they waited through.  The paths now walk as
// bounce_step's rays do (bounce<.., kRender>): a (ray, block) pair's
// triangles on the warp's 32 lanes (closest_coop, occluded_coop,
// soft_visibility<kRender>), 8 paths a warp, so that the few CTAs whose
// paths bounce longest hold a quarter of the pairs they held with 32;
// a binned depth 0 reads the tile's chunks staged by the CTA, split over
// the path's four threads (closest_binned_cta<kRenderSplit>, A's walk).
// The depth loop runs while a path of the warp is alive; a lane without
// a live path (a path's other threads, or one that has died) passes live
// = false, still tests the others' pairs, and keeps its state.  The
// branches around the collectives are uniform: has_work over the CTA,
// the sample loop and the depth loop over the warp.
template <bool CPU>
__global__ void __launch_bounds__(kThreads)
render_kernel(SceneArgs s, const int* xs, const int* ys, const int* has_work,
              int n_rays, int rt, int spp, int sample_offset, int center,
              int terminal, int max_depth, float* r_out, float* g_out,
              float* b_out) {
  const int thread = blockIdx.x * kThreads + threadIdx.x;
  const int gid = thread / kRenderSplit;
  const bool owner = thread % kRenderSplit == 0;
  const int tile = gid / rt;
  const float* cam = s.cam;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (!CPU && !has_work[tile]) {  // CTA-uniform
    for (int k = 0; k < spp; ++k)
      for (int c = 0; c < 3; ++c) acc[c] = acc[c] + clip01(cam[12 + c]);
  } else {
    const Shared sh = stage_shared(s, s.cand_chunk != 0);
    for (int k = 0; k < spp; ++k) {
      Ray r;
      primary(cam, xs[gid], ys[gid], (uint32_t)(sample_offset + k),
              center != 0, r);
      bounce<CPU, false, kRender>(s, sh, cam, r, s.cand_chunk ? tile : -1,
                                  nullptr, owner);
      bool live = owner && r.alive > 0.0f;
      for (int depth = 1;
           !terminal && depth < max_depth && __any_sync(kFull, live);
           ++depth) {
        Ray w = r;
        bounce<CPU, false, kRender>(s, sh, cam, w, -1, nullptr, live);
        if (live) r = w;
        live = r.alive > 0.0f;
      }
      for (int c = 0; c < 3; ++c)
        acc[c] = acc[c] + (CPU ? r.rd[c] : clip01(r.rd[c]));
    }
  }
  if (!owner) return;
  r_out[gid] = acc[0];
  g_out[gid] = acc[1];
  b_out[gid] = acc[2];
}

// The staged integrator's closest hit (E, _closest_kernel): the flat block
// scan on [tmin[i], best t] of each ray; with_normal adds the gpu shading
// normal (0, 0, 1 on a miss); each of the n_shadow point lights then gets
// the fused IsInShadow walk of _closest_kernel in its op order:
// p = o + t d + n eps, dist = sqrt(max(|to|^2, 1e-38)), direction
// to * (1 / dist), any hit on [shadow_tmin, dist]; lanes that miss or face
// away (N.L <= 0 or N.V <= 0) trace nothing and get visibility 0.  The
// Pallas kernel's superblock plan, early exit and quarter gating are TPU
// schedules: the (t, id) take rule gives the same winners in any order.
//
// Measured first (scripts/profile_torch_main_path.py --staged): as first
// ported, one thread a ray walking alone, a block's 512 triangles were
// tested one a step in one lane, and the warps holding the few rays with
// long walks set the time (on the 1080p frog the last CTA ended at 3.7x
// the mean at depth 0, 21-51x at depths 1-7); after depth 0 only a few
// percent of the rays the integrator feeds live (the others are parked
// off the grid), yet each depth took 6-8 ms.  So E runs as emit's shadow
// walk does, in three launches (rt_closest): a ray a thread writes the
// miss of a ray whose slab test passes no block (parked rays, rays to
// the sky) and lists the others; a grid that fills the card walks that
// list kRaysPerWarp rays a warp (fewer when the list is short), a (ray,
// block) pair's triangles on the warp's 32 lanes (closest_coop), shades
// the hits and lists the facing (ray, light) entries whose slab test
// passes some block; a third launch walks that list (walk_list) and
// clears the visibility of the blocked ones.  Bound on this card: FP32
// Moller-Trumbore per ray-triangle pair, planes read from L2; nothing
// here for the tensor cores.

// E's rays and results (block_closest): n (R, 3) and vis (R, n_shadow)
// only with with_normal, lights the (n_shadow, 3) point-light positions.
struct ClosestIO {
  const float* orig;
  const float* dir;
  const float* tmin;
  const float* lights;
  int n_shadow;
  int with_normal;
  float* t;
  float* u;
  float* v;
  int* id;
  float* n;
  float* vis;
};

// Append the entries of a warp's lanes that `want` to the list (every
// lane of the warp calls it): one atomicAdd a warp.
__device__ void warp_append(const Shadows& q, bool want, int entry) {
  const int lane = threadIdx.x & 31;
  const unsigned ball = __ballot_sync(kFull, want);
  int base = 0;
  if (lane == 0 && ball) base = atomicAdd(&q.counts[0], __popc(ball));
  base = __shfl_sync(kFull, base, 0);
  if (want) q.list[base + __popc(ball & ((1u << lane) - 1u))] = entry;
}

// The shade point of a hit and its shadow ray toward point light L: unit
// direction sd and distance, in _closest_kernel's op order (both launches
// that need it compute it here, to the same bits).
__device__ __forceinline__ void light_ray(const float* o, const float* d,
                                          float t, const float* n,
                                          float eps, const float* L,
                                          float* p, float* sd,
                                          float* dist) {
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = o[c] + t * d[c] + n[c] * eps;
  const float to[3] = {L[0] - p[0], L[1] - p[1], L[2] - p[2]};
  *dist = sqrtf(fmaxf(to[0] * to[0] + to[1] * to[1] + to[2] * to[2], 1e-38f));
  const float inv_dist = 1.0f / *dist;
#pragma unroll
  for (int c = 0; c < 3; ++c) sd[c] = to[c] * inv_dist;
}

// E's first launch: a ray a thread.  The closest walk's first slab test
// (closest_coop's, on [tmin, FLT_MAX]) passes no block: the ray misses and
// traces no shadow, and its results are written here; else it is listed.
__global__ void __launch_bounds__(kThreads)
closest_kernel(SceneArgs s, ClosestIO io, int n_rays, Shadows q) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  bool listed = false;
  if (gid < n_rays) {
    const float* o = io.orig + 3 * gid;
    const float* d = io.dir + 3 * gid;
    const float inv[3] = {1.0f / d[0], 1.0f / d[1], 1.0f / d[2]};
    listed = next_block(s, sh, o, inv, io.tmin[gid], kF32Max, 0) <
             s.num_blocks;
    if (!listed) {
      io.t[gid] = kF32Max;
      io.u[gid] = 0.0f;
      io.v[gid] = 0.0f;
      io.id[gid] = -1;
      if (io.with_normal) {
        io.n[3 * gid] = 0.0f;
        io.n[3 * gid + 1] = 0.0f;
        io.n[3 * gid + 2] = 1.0f;
        for (int li = 0; li < io.n_shadow; ++li)
          io.vis[(size_t)gid * io.n_shadow + li] = 0.0f;
      }
    }
  }
  list_append(q, listed, gid);
}

// E's second launch: the warps take up to kRaysPerWarp entries of the ray
// list at a time until it is done and walk them together (closest_coop);
// with with_normal each hit's normal, and per light its visibility: 1
// where it faces the light, its entry gid * n_shadow + li listed in qs if
// its slab test passes some block on [shadow_tmin, dist] (else nothing
// can block it), 0 on a miss or facing away.
__global__ void __launch_bounds__(kThreads)
closest_walk_kernel(SceneArgs s, ClosestIO io, Shadows q, Shadows qs) {
  const Shared sh = stage_shared(s);
  take_groups(q, kRaysPerWarp, [&](int gid, bool active) {
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {1.0f, 1.0f, 1.0f}, tmin = 0.0f;
    if (active) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = io.orig[3 * gid + c];
        d[c] = io.dir[3 * gid + c];
      }
      tmin = io.tmin[gid];
    }
    const Hit h = closest_coop(s, sh, o, d, tmin, active);
    if (active) {
      io.t[gid] = h.t;
      io.u[gid] = h.u;
      io.v[gid] = h.v;
      io.id[gid] = h.id;
    }
    if (!io.with_normal) return;  // uniform
    const bool hit = active && h.t < kF32Max;
    float n[3] = {0.0f, 0.0f, 1.0f};
    if (hit) shading_normal<false>(s, h, d, n);
    if (active)
      for (int c = 0; c < 3; ++c) io.n[3 * gid + c] = n[c];
    const float ndotv = -(n[0] * d[0] + n[1] * d[1] + n[2] * d[2]);
    for (int li = 0; li < io.n_shadow; ++li) {
      float p[3], sd[3], dist;
      light_ray(o, d, h.t, n, s.shadow_eps, io.lights + 3 * li, p, sd, &dist);
      const float ndotl = n[0] * sd[0] + n[1] * sd[1] + n[2] * sd[2];
      const bool facing = hit && ndotl > 0.0f && ndotv > 0.0f;
      const float inv[3] = {1.0f / sd[0], 1.0f / sd[1], 1.0f / sd[2]};
      const bool walks =
          facing &&
          next_block(s, sh, p, inv, s.shadow_tmin, dist, 0) < s.num_blocks;
      if (active)
        io.vis[(size_t)gid * io.n_shadow + li] = facing ? 1.0f : 0.0f;
      warp_append(qs, walks, gid * io.n_shadow + li);
    }
  });
}

// E's third launch: the listed shadow rays, made again from the hits the
// second launch wrote, walked as emit's are; a blocked one's visibility
// is cleared.
__global__ void __launch_bounds__(kThreads)
closest_shadow_kernel(SceneArgs s, ClosestIO io, Shadows qs) {
  const Shared sh = stage_shared(s);
  walk_list(s, sh, qs, [&](int entry, float* row) {
    const int gid = entry / io.n_shadow, li = entry % io.n_shadow;
    const float* o = io.orig + 3 * gid;
    const float* d = io.dir + 3 * gid;
    const float* n = io.n + 3 * gid;
    light_ray(o, d, io.t[gid], n, s.shadow_eps, io.lights + 3 * li, row,
              row + 3, &row[7]);
    row[6] = s.shadow_tmin;
    row[8] = row[7];
  }, [&](int entry) { io.vis[entry] = 0.0f; });
}

// The staged integrator's any-hit test (F, _occluded_kernel), every ray
// on [tmin[i], tmax[i]] (blocks culled and triangles tested on it), in
// two launches (rt_occluded): a ray a thread clears its flag and is
// listed if one of its slab tests passes (the parked rays, and most
// rays toward the sky, are done after their slab tests); then a grid
// that fills the card walks the list.
__global__ void __launch_bounds__(kThreads)
occluded_kernel(SceneArgs s, const float* orig, const float* dir,
                const float* tmin, const float* tmax, int n_rays,
                Shadows q) {
  const Shared sh = stage_shared(s);
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  bool listed = false;
  if (gid < n_rays) {
    const float o[3] = {orig[3 * gid], orig[3 * gid + 1], orig[3 * gid + 2]};
    const float inv[3] = {1.0f / dir[3 * gid], 1.0f / dir[3 * gid + 1],
                          1.0f / dir[3 * gid + 2]};
    listed =
        next_block(s, sh, o, inv, tmin[gid], tmax[gid], 0) < s.num_blocks;
    q.flags[gid] = 0;
  }
  list_append(q, listed, gid);
}

__global__ void __launch_bounds__(kThreads)
occluded_walk_kernel(SceneArgs s, const float* orig, const float* dir,
                     const float* tmin, const float* tmax, Shadows q) {
  const Shared sh = stage_shared(s);
  walk_list(s, sh, q, [&](int gid, float* row) {
    for (int c = 0; c < 3; ++c) {
      row[c] = orig[3 * gid + c];
      row[3 + c] = dir[3 * gid + c];
    }
    row[6] = tmin[gid];
    row[7] = tmax[gid];
    row[8] = tmax[gid];
  }, [&](int gid) { q.flags[gid] = 1; });
}

// ---- C interface (loaded with ctypes) ----

namespace {

size_t shared_bytes(const SceneArgs& s) {
  return sizeof(float) *
         (6 * (size_t)s.num_blocks + 8 * (size_t)s.n_lights +
          16 * (size_t)s.n_objects);
}

// emit and the render: the staged rows, then (binned) two chunk buffers,
// 16-byte aligned
size_t emit_shared_bytes(const SceneArgs& s) {
  if (!s.cand_chunk) return shared_bytes(s);
  return (shared_bytes(s) + 15) / 16 * 16 +
         2 * sizeof(float) * kStageRows * (size_t)s.cand_chunk;
}

template <typename K>
int prepare(K kernel, const SceneArgs& s, size_t smem) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const size_t total = smem + fa.sharedSizeBytes;  // dynamic + static
  if (total > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (total > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (s.cand_chunk && (!s.cand_meta || !s.cand_stream))
    return (int)cudaErrorInvalidValue;
  return 0;
}

int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

// a list walk's grid: as many CTAs as the card holds at once
template <typename K>
int fill_blocks(K kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads,
                                                       smem);
  *blocks = sms * (per > 0 ? per : 1);
  return (int)e;
}

// bounce_step_kernel: a warp for each `rays` rays
int coop_blocks_for(int n_rays, int rays) {
  const long long warps = (n_rays + rays - 1) / rays;
  return (int)((warps * 32 + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Scratch of emit's three launches, from the caller: counts (2,), list
// (n_rays * rounds,), flags (n_rays * rounds,), hits (5 * n_rays,);
// rounds: the walks a ray may make (the lights, or, cpuonly, their disk
// samples).
int rt_emit(const SceneArgs* s, const int* xs, const int* ys,
            const int* has_work, int n_rays, int rt, int sample_offset,
            int center, float* st_out, int* rng_out, int* counts, int* list,
            unsigned char* flags, float* hits, int rounds, void* stream) {
  // a CTA must lie in one tile (emit_kernel)
  if (rt % (kThreads / kEmitSplit) || n_rays % rt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Shadows q{counts, list, flags, hits, rounds, n_rays};
  auto hit_k = s->cpuonly ? &emit_kernel<true> : &emit_kernel<false>;
  auto walk_k = s->cpuonly ? &emit_walk_kernel<true> : &emit_walk_kernel<false>;
  auto finish_k =
      s->cpuonly ? &emit_finish_kernel<true> : &emit_finish_kernel<false>;
  const size_t smem = emit_shared_bytes(*s), smem_rows = shared_bytes(*s);
  int walk_blocks = 0;
  int e = prepare(hit_k, *s, smem);
  if (!e) e = prepare(walk_k, *s, smem_rows);
  if (!e) e = prepare(finish_k, *s, smem_rows);
  if (!e) e = fill_blocks(walk_k, smem_rows, &walk_blocks);
  if (!e) e = (int)cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
  if (e) return e;
  hit_k<<<blocks_for(n_rays * kEmitSplit), kThreads, smem, st>>>(
      *s, xs, ys, has_work, n_rays, rt, sample_offset, center, st_out,
      rng_out, q);
  walk_k<<<walk_blocks, kThreads, smem_rows, st>>>(*s, xs, ys, sample_offset,
                                                   center, q);
  finish_k<<<blocks_for(n_rays), kThreads, smem_rows, st>>>(
      *s, xs, ys, has_work, rt, sample_offset, center, st_out, rng_out, q);
  return (int)cudaGetLastError();
}

// diff_out: nullptr, or the (nt*8, rt) oracle rows (gpu dialect only).
// A binned plan (cand_chunk) is taken only with diff_out.
int rt_bounce_step(const SceneArgs* s, const float* st_in, const int* rng_in,
                   int n_rays, int rt, float* st_out, int* rng_out,
                   float* diff_out, void* stream) {
  if ((diff_out && s->cpuonly) || (s->cand_chunk && !diff_out))
    return (int)cudaErrorInvalidValue;
  const bool binned = s->cand_chunk != 0;
  auto kernel = s->cpuonly ? &bounce_step_kernel<true, false, kRaysPerWarp>
                : binned   ? &bounce_step_kernel<false, true, 32>
                : diff_out ? &bounce_step_kernel<false, true, kRaysPerWarp>
                           : &bounce_step_kernel<false, false, kRaysPerWarp>;
  int e = prepare(kernel, *s, shared_bytes(*s));
  if (e) return e;
  kernel<<<coop_blocks_for(n_rays, binned ? 32 : kRaysPerWarp), kThreads,
           shared_bytes(*s), (cudaStream_t)stream>>>(
      *s, st_in, rng_in, n_rays, rt, st_out, rng_out, diff_out);
  return (int)cudaGetLastError();
}

int rt_resume(const SceneArgs* s, const float* st_in, const int* rng_in,
              int n_rays, int rt, int max_depth, float* r_out, float* g_out,
              float* b_out, void* stream) {
  constexpr int rays = kResumeRays;
  auto kernel = s->cpuonly ? &resume_kernel<true, rays>
                           : &resume_kernel<false, rays>;
  int e = prepare(kernel, *s, shared_bytes(*s));
  if (e || n_rays == 0) return e;
  kernel<<<coop_blocks_for(n_rays, rays), kThreads, shared_bytes(*s),
           (cudaStream_t)stream>>>(*s, st_in, rng_in, n_rays, rt, max_depth,
                                   r_out, g_out, b_out);
  return (int)cudaGetLastError();
}

int rt_render(const SceneArgs* s, const int* xs, const int* ys,
              const int* has_work, int n_rays, int rt, int spp,
              int sample_offset, int center, int terminal, int max_depth,
              float* r_out, float* g_out, float* b_out, void* stream) {
  // a CTA must lie in one tile (render_kernel)
  if (rt % (kThreads / kRenderSplit) || n_rays % rt)
    return (int)cudaErrorInvalidValue;
  auto kernel = s->cpuonly ? &render_kernel<true> : &render_kernel<false>;
  const size_t smem = emit_shared_bytes(*s);  // and the chunk buffers
  int e = prepare(kernel, *s, smem);
  if (e || n_rays == 0) return e;
  kernel<<<n_rays / (kThreads / kRenderSplit), kThreads, smem,
           (cudaStream_t)stream>>>(
      *s, xs, ys, has_work, n_rays, rt, spp, sample_offset, center, terminal,
      max_depth, r_out, g_out, b_out);
  return (int)cudaGetLastError();
}

// Scratch from the caller: counts (4,), the ray list's two counters, then
// the shadow list's; list (n_rays,); shadow_list (n_rays * n_shadow,).
int rt_closest(const SceneArgs* s, const float* orig, const float* dir,
               const float* tmin, int n_rays, int with_normal,
               const float* shadow_lights, int n_shadow, float* t_out,
               float* u_out, float* v_out, int* idx_out, float* n_out,
               float* vis_out, int* counts, int* list, int* shadow_list,
               void* stream) {
  if (n_shadow && !with_normal) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const ClosestIO io{orig,  dir,   tmin,  shadow_lights, n_shadow, with_normal,
                     t_out, u_out, v_out, idx_out,       n_out,    vis_out};
  const Shadows q{counts, list, nullptr, nullptr, 1, n_rays};
  const Shadows qs{counts + 2, shadow_list, nullptr, nullptr, n_shadow,
                   n_rays};
  const size_t smem = shared_bytes(*s);
  int walk_blocks = 0, shadow_blocks = 0;
  int e = prepare(&closest_kernel, *s, smem);
  if (!e) e = prepare(&closest_walk_kernel, *s, smem);
  if (!e) e = prepare(&closest_shadow_kernel, *s, smem);
  if (!e) e = fill_blocks(&closest_walk_kernel, smem, &walk_blocks);
  if (!e) e = fill_blocks(&closest_shadow_kernel, smem, &shadow_blocks);
  if (!e) e = (int)cudaMemsetAsync(counts, 0, 4 * sizeof(int), st);
  if (e || n_rays == 0) return e;
  closest_kernel<<<blocks_for(n_rays), kThreads, smem, st>>>(*s, io, n_rays,
                                                             q);
  closest_walk_kernel<<<walk_blocks, kThreads, smem, st>>>(*s, io, q, qs);
  if (n_shadow)
    closest_shadow_kernel<<<shadow_blocks, kThreads, smem, st>>>(*s, io, qs);
  return (int)cudaGetLastError();
}

// Scratch from the caller: counts (2,), list (n_rays,).
int rt_occluded(const SceneArgs* s, const float* orig, const float* dir,
                const float* tmin, const float* tmax, int n_rays,
                unsigned char* blocked, int* counts, int* list,
                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Shadows q{counts, list, blocked, nullptr, 1, n_rays};
  const size_t smem = shared_bytes(*s);
  int walk_blocks = 0;
  int e = prepare(&occluded_kernel, *s, smem);
  if (!e) e = prepare(&occluded_walk_kernel, *s, smem);
  if (!e) e = fill_blocks(&occluded_walk_kernel, smem, &walk_blocks);
  if (!e) e = (int)cudaMemsetAsync(counts, 0, 2 * sizeof(int), st);
  if (e) return e;
  occluded_kernel<<<blocks_for(n_rays), kThreads, smem, st>>>(
      *s, orig, dir, tmin, tmax, n_rays, q);
  occluded_walk_kernel<<<walk_blocks, kThreads, smem, st>>>(*s, orig, dir,
                                                            tmin, tmax, q);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
