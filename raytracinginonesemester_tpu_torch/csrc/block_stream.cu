// Streamed closest-hit and occlusion kernels for Hopper (sm_90a): the
// staged integrator's kernels for scenes over the plane budget.
//
// Replaces the Pallas TPU kernels of raytracinginonesemester_tpu/ops/
// pallas_kernels.py:
// - G: _closest_streamed_kernel (pallas_block_closest_streamed), the
//   per-tile front-to-back superblock walk with early exit;
// - I: _occluded_streamed_kernel (pallas_block_occluded_streamed), the same
//   walk until every lane of the tile is blocked or the plan runs out;
// - H: _closest_blockmajor_kernel (pallas_block_closest_blockmajor and
//   pallas_block_occluded_blockmajor), the slab-major sweep of each ray
//   chunk's gated scene slabs.
//
// Design.  One CTA of 512 threads per 512-ray tile, one thread per ray; the
// wrapper (ops/block_kernels.py) pads the rays to whole tiles with parked
// filler (origin 1e30) and builds the plan (order, entry) or the (I, J) gate
// with torch ops on the card.  The planes are block-major rows, so one
// block (9 planes and its ids, 10 * B * 4 bytes: 20 KiB at B = 512) is one
// contiguous run.  For each block of the walk every thread runs the slab
// test against its own window (closest: its running best t; occlusion: its
// [tmin, tmax] while unblocked); if any thread passes (__syncthreads_or),
// the CTA stages the block into shared memory and the threads that passed
// test its triangles with the (t, global id) take rule (closest) or until
// their first hit (occlusion).  A superblock (8 blocks, 160 KiB) does not
// fit twice into 227 KB, so the staging is block by block and not double
// buffered.  G keeps the JAX early-exit rule: the walk goes on while the
// next superblock's entry is <= the largest best t of the tile's lanes, so
// a tile with a missed or padding lane (t = F32_MAX) never exits early.
// None of this changes a winner: the take rule does not depend on the
// order, and the culling is conservative.  A ray with a zero direction
// skips every block: its Moller-Trumbore determinant is exactly 0, below
// det_eps, so it cannot hit.  These are the shadow rays of parked shade
// points (origin 1e30, distance inf, direction 0): their window [1e-4,
// inf] passes every slab test, and the JAX kernels, whose dense tile test
// costs the same for any lane count, test them against every block their
// tile visits; here that would be the bulk of the work.
//
// What bounds it on this card: the FP32 Moller-Trumbore work of the lanes
// that pass their slab tests, and the block staging (each staged block is
// read from L2 or HBM once per tile that visits it).  This version is
// simple and exact; cp.async/TMA double buffering is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

constexpr int kTile = 512;  // rays per tile = threads per CTA
constexpr int kSuper = 8;   // blocks per superblock (ops/accel.py SUPER)

struct TileRay {
  float o[3], d[3], inv[3], tmin, tmax;
  bool moving;  // a zero direction never hits (see the design note)
};

__device__ __forceinline__ TileRay load_ray(const float* rays, size_t gid) {
  const float* r = rays + 8 * gid;  // (RP, 8): o xyz, d xyz, tmin, tmax
  TileRay t;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.o[c] = r[c];
    t.d[c] = r[3 + c];
    t.inv[c] = 1.0f / r[3 + c];
  }
  t.tmin = r[6];
  t.tmax = r[7];
  t.moving = t.d[0] != 0.0f || t.d[1] != 0.0f || t.d[2] != 0.0f;
  return t;
}

// Block b's 9 plane rows and ids into shared memory (coalesced).
__device__ __forceinline__ void stage_block(const float* __restrict__ tri,
                                            const int* __restrict__ ids,
                                            int b, int bs, float* s_tri,
                                            int* s_ids) {
  const float* src = tri + (size_t)b * 9 * bs;
  for (int q = threadIdx.x; q < 9 * bs; q += blockDim.x) s_tri[q] = src[q];
  for (int q = threadIdx.x; q < bs; q += blockDim.x)
    s_ids[q] = ids[(size_t)b * bs + q];
}

// Closest hit of this thread's ray over the staged block b.
__device__ __forceinline__ void closest_block(Hit& h, const TileRay& r,
                                              const float* s_tri,
                                              const int* s_ids, int b, int bs,
                                              float det_eps) {
  for (int j = 0; j < bs; ++j) {
    const int id = s_ids[j];
    if (id < 0) continue;
    float u, v;
    const float t = mt(s_tri + j, bs, det_eps, r.o, r.d, r.tmin, h.t, &u, &v);
    take(h, t, u, v, id, b * bs + j);
  }
}

// Any hit of this thread's ray on [tmin, tmax] in the staged block.
__device__ __forceinline__ bool any_hit_block(const TileRay& r,
                                              const float* s_tri,
                                              const int* s_ids, int bs,
                                              float det_eps) {
  for (int j = 0; j < bs; ++j) {
    if (s_ids[j] < 0) continue;
    float u, v;
    if (mt(s_tri + j, bs, det_eps, r.o, r.d, r.tmin, r.tmax, &u, &v) <
        kF32Max)
      return true;
  }
  return false;
}

// The largest value of x over the CTA (every thread gets it); red: one
// float per warp in shared memory.
__device__ __forceinline__ float tile_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

}  // namespace

// G: closest hit by the tile's front-to-back superblock plan.
__global__ void __launch_bounds__(kTile)
closest_streamed_kernel(const float* __restrict__ rays,
                        const float* __restrict__ aabb,
                        const int* __restrict__ order,
                        const float* __restrict__ entry,
                        const float* __restrict__ tri,
                        const int* __restrict__ ids, int num_blocks,
                        int num_supers, int bs, float det_eps, float* t_out,
                        float* u_out, float* v_out, int* idx_out) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  int* s_ids = reinterpret_cast<int*>(smem + 9 * bs);
  __shared__ float red[kTile / 32];
  const int tile = blockIdx.x;
  const size_t gid = (size_t)tile * kTile + threadIdx.x;
  const TileRay r = load_ray(rays, gid);
  const int* ord = order + (size_t)tile * num_supers;
  const float* ent = entry + (size_t)tile * num_supers;
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  for (int k = 0; k < num_supers; ++k) {
    if (!(ent[k] <= tile_max(h.t, red))) break;  // front-to-back early exit
    const int sb = ord[k];
    for (int j = 0; j < kSuper; ++j) {
      const int b = sb * kSuper + j;
      if (b >= num_blocks) break;
      const bool pass =
          r.moving && slab(aabb + 8 * b, r.o, r.inv, r.tmin, h.t);
      if (!__syncthreads_or(pass)) continue;
      stage_block(tri, ids, b, bs, s_tri, s_ids);
      __syncthreads();
      if (pass) closest_block(h, r, s_tri, s_ids, b, bs, det_eps);
      __syncthreads();
    }
  }
  t_out[gid] = h.t;
  u_out[gid] = h.u;
  v_out[gid] = h.v;
  idx_out[gid] = h.id;
}

// I: any hit by the same plan; the tile stops once every lane is blocked.
__global__ void __launch_bounds__(kTile)
occluded_streamed_kernel(const float* __restrict__ rays,
                         const float* __restrict__ aabb,
                         const int* __restrict__ order,
                         const float* __restrict__ entry,
                         const float* __restrict__ tri,
                         const int* __restrict__ ids, int num_blocks,
                         int num_supers, int bs, float det_eps,
                         unsigned char* blocked_out) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  int* s_ids = reinterpret_cast<int*>(smem + 9 * bs);
  const int tile = blockIdx.x;
  const size_t gid = (size_t)tile * kTile + threadIdx.x;
  const TileRay r = load_ray(rays, gid);
  const int* ord = order + (size_t)tile * num_supers;
  const float* ent = entry + (size_t)tile * num_supers;
  bool blocked = false;
  for (int k = 0; k < num_supers; ++k) {
    if (!(ent[k] < INFINITY)) break;
    if (!__syncthreads_or(!blocked)) break;
    const int sb = ord[k];
    for (int j = 0; j < kSuper; ++j) {
      const int b = sb * kSuper + j;
      if (b >= num_blocks) break;
      const bool pass = r.moving && !blocked &&
                        slab(aabb + 8 * b, r.o, r.inv, r.tmin, r.tmax);
      if (!__syncthreads_or(pass)) continue;
      stage_block(tri, ids, b, bs, s_tri, s_ids);
      __syncthreads();
      if (pass) blocked = any_hit_block(r, s_tri, s_ids, bs, det_eps);
      __syncthreads();
    }
  }
  blocked_out[gid] = blocked;
}

// H: each tile sweeps its chunk's gated slabs in order, blocks in order.
template <bool OCC>
__global__ void __launch_bounds__(kTile)
blockmajor_kernel(const float* __restrict__ rays,
                  const float* __restrict__ aabb,
                  const int* __restrict__ gate, const float* __restrict__ tri,
                  const int* __restrict__ ids, int num_blocks, int num_slabs,
                  int slab_blocks, int chunk_tiles, int bs, float det_eps,
                  float* t_out, float* u_out, float* v_out, int* idx_out,
                  unsigned char* blocked_out) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  int* s_ids = reinterpret_cast<int*>(smem + 9 * bs);
  const int tile = blockIdx.x;
  const size_t gid = (size_t)tile * kTile + threadIdx.x;
  const TileRay r = load_ray(rays, gid);
  const int* gate_row = gate + (size_t)(tile / chunk_tiles) * num_slabs;
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  bool blocked = false;
  for (int j = 0; j < num_slabs; ++j) {
    if (!gate_row[j]) continue;
    for (int bb = 0; bb < slab_blocks; ++bb) {
      const int b = j * slab_blocks + bb;
      if (b >= num_blocks) break;  // padding blocks hold no triangle
      // occlusion: a blocked ray's window is closed
      const bool pass =
          r.moving &&
          (OCC ? !blocked && slab(aabb + 8 * b, r.o, r.inv, r.tmin, r.tmax)
               : slab(aabb + 8 * b, r.o, r.inv, r.tmin, h.t));
      if (!__syncthreads_or(pass)) continue;
      stage_block(tri, ids, b, bs, s_tri, s_ids);
      __syncthreads();
      if (pass) {
        if (OCC)
          blocked = any_hit_block(r, s_tri, s_ids, bs, det_eps);
        else
          closest_block(h, r, s_tri, s_ids, b, bs, det_eps);
      }
      __syncthreads();
    }
  }
  if (OCC) {
    blocked_out[gid] = blocked;
  } else {
    t_out[gid] = h.t;
    u_out[gid] = h.u;
    v_out[gid] = h.v;
    idx_out[gid] = h.id;
  }
}

// ---- C interface (loaded with ctypes) ----

namespace {

template <typename K>
int prepare(K kernel, int bs, size_t* smem) {
  *smem = (size_t)10 * bs * sizeof(float);
  if (*smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (*smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// rays (n_tiles * 512, 8); aabb (>= num_blocks, 8); order, entry
// (n_tiles, num_supers); tri (>= num_blocks * 9, bs) and ids
// (>= num_blocks, bs) block-major.
int rt_closest_streamed(const float* rays, const float* aabb, const int* order,
                        const float* entry, const float* tri, const int* ids,
                        int n_tiles, int num_blocks, int num_supers, int bs,
                        float det_eps, float* t_out, float* u_out,
                        float* v_out, int* idx_out, void* stream) {
  size_t smem;
  int e = prepare(&closest_streamed_kernel, bs, &smem);
  if (e || n_tiles == 0) return e;
  closest_streamed_kernel<<<n_tiles, kTile, smem, (cudaStream_t)stream>>>(
      rays, aabb, order, entry, tri, ids, num_blocks, num_supers, bs, det_eps,
      t_out, u_out, v_out, idx_out);
  return (int)cudaGetLastError();
}

int rt_occluded_streamed(const float* rays, const float* aabb,
                         const int* order, const float* entry,
                         const float* tri, const int* ids, int n_tiles,
                         int num_blocks, int num_supers, int bs,
                         float det_eps, unsigned char* blocked_out,
                         void* stream) {
  size_t smem;
  int e = prepare(&occluded_streamed_kernel, bs, &smem);
  if (e || n_tiles == 0) return e;
  occluded_streamed_kernel<<<n_tiles, kTile, smem, (cudaStream_t)stream>>>(
      rays, aabb, order, entry, tri, ids, num_blocks, num_supers, bs, det_eps,
      blocked_out);
  return (int)cudaGetLastError();
}

// gate (n_tiles / chunk_tiles, num_slabs) int32; occluded: write
// blocked_out, else t, u, v, idx.
int rt_blockmajor(const float* rays, const float* aabb, const int* gate,
                  const float* tri, const int* ids, int n_tiles,
                  int num_blocks, int num_slabs, int slab_blocks,
                  int chunk_tiles, int bs, float det_eps, int occluded,
                  float* t_out, float* u_out, float* v_out, int* idx_out,
                  unsigned char* blocked_out, void* stream) {
  if (chunk_tiles <= 0 || slab_blocks <= 0 || n_tiles % chunk_tiles)
    return (int)cudaErrorInvalidValue;
  auto kernel = occluded ? &blockmajor_kernel<true> : &blockmajor_kernel<false>;
  size_t smem;
  int e = prepare(kernel, bs, &smem);
  if (e || n_tiles == 0) return e;
  kernel<<<n_tiles, kTile, smem, (cudaStream_t)stream>>>(
      rays, aabb, gate, tri, ids, num_blocks, num_slabs, slab_blocks,
      chunk_tiles, bs, det_eps, t_out, u_out, v_out, idx_out, blocked_out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
