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
// The operands.  The wrapper (ops/block_kernels.py) pads the rays to whole
// 512-ray tiles with parked filler (origin 1e30) and builds the plan
// (order, entry, the length of each tile's row) or the (I, J) gate, and
// the tiles' launch order, with torch ops on the card.  The planes are
// block-major rows, so one block (9 planes and its ids, 10 * B * 4 bytes:
// 20 KiB at B = 512) is one contiguous run.
//
// What bounds G and I on this card (measured on an H100 80GB HBM3 at
// 700 W, scripts/profile_torch_main_path.py --streamed, on the large
// frog's 2,073,600 camera and shadow rays): the work is 1,063,102 (G) and
// 421,204 (I) (ray, block) pairs of up to 512 Moller-Trumbore tests, 21
// and 11 passing rays a staged block.  Walked as first ported, one thread
// a ray, a pair was a chain of 512 dependent tests in one lane of its warp
// while the CTA's other lanes waited at the block's barrier, and the
// CTAs holding the most pairs ended at 2.1x (G) and 3.5x (I) the mean:
// 34.0 and 41.2 ms for a walk whose FP32 work is 0.37 and 0.14 ms at the
// card's peak rate, staging 1.7% of it.
//
// G and I (streamed_kernel<OCC, false>).  Two CTAs of 256 threads walk a
// tile, CTA p of the tile taking its rays p, p + 2, ..., a thread holding
// a ray for its slab tests (the plan is conservative for any subset of
// the tile's rays); so a tile's pairs split evenly between two CTAs.  First a
// CTA marks its candidates: every block of the tile's plan row whose slab
// test passes for one of its active lanes on the lane's window at the
// start (one ballot a block, no barrier).
// Then it takes them in plan order, the next one staged with cp.async
// into the other of two buffers while the current one is tested.  Before
// each it stops, G once the superblock's entry exceeds every active lane's
// best t, I once every active lane is blocked (its own lanes); otherwise
// the lanes whose slab test passes on their window now are listed (ballot,
// prefix), and the 8 warps take the list's (ray, block) pairs in turn, 32
// lanes to a pair, lane l testing triangles l, l + 32, ... at the owner's
// window.
// G keeps a lane's first (t, id) minimum, a fixed xor tree the (t, id,
// slot) minimum of the warp, and the owner takes it by the take rule:
// that is the sequential walk's winner, since a triangle the shrunken
// window would reject has a larger t than the hit that shrank it, and
// mt() gives t, u and v from the same inputs either way.  I votes every
// kVote triangles.  The tiles launch longest plan first, so that the
// CTAs that walk the most start first: G 3.69-3.78 ms and I 2.83-2.84
// against 4.04-4.07 and 3.18-3.19 in plan order (in turns, scripts/
// profile_torch_main_path.py --streamed, H100 80GB HBM3, 700 W).  With
// one CTA a tile the CTAs holding a heavy tile's pairs still ended last:
// G took
// 3.94-3.98 ms and I 3.28-3.34 against 3.65-3.79 and 2.82-2.85 with two
// CTAs a tile, and 3.79-3.81 and 2.77 with four (in turns on the same
// card; 34.0 and 41.2 as first ported).  Active lanes
// are the real rays with a nonzero direction: a zero direction cannot
// hit (its determinant is 0, below det_eps) and the padding is not a
// ray, so leaving them out of the exit tests (the JAX kernels keep them,
// which stops a G tile from ever leaving early) changes no output.  These
// are the shadow rays of parked shade points (origin 1e30, distance inf,
// direction 0), which the JAX kernels' dense tile test checks against
// every block their tile visits.  The candidates are a superset of the
// blocks the walk needs (the windows only shrink), the slab tests and the
// take rule are the JAX kernels', and the culling is conservative, so
// the winners and flags are the plain versions' bit for bit; G tests the
// same (ray, block) pairs as the JAX walk, I up to the vote after a hit.
//
// H (streamed_kernel<OCC, true>) walks the same way; its candidates are
// the blocks of the slabs its chunk's gate lets through, in block order,
// and its closest hit has no exit (the JAX sweep has none).  A warp first
// tests a slab's union box and marks none of its blocks if no lane of it
// passes (measured: marking every gated block took 0.55 of H closest's
// cycles).  As first ported, one CTA of 512 threads a tile walked them a
// thread a ray (a barrier a block, the block staged while nothing else
// ran, a passing lane's 512 tests alone): 37.3 and 37.1 ms on the large
// frog's camera and shadow rays, now 3.8 and 2.2 (in turns, scripts/
// profile_torch_main_path.py --streamed --parent, H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

constexpr int kTile = 512;      // rays per tile
constexpr int kSplit = 2;       // CTAs a tile
constexpr int kThreads = kTile / kSplit;  // threads (rays) a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSuper = 8;       // blocks per superblock (ops/accel.py SUPER)
constexpr int kPairLanes = 32;  // lanes that test one (ray, block) pair
constexpr int kVote = 128;      // I, H: triangles a pair tests between votes
constexpr int kBuffers = 2;     // staged blocks in flight
constexpr unsigned kFull = 0xffffffffu;

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

// ---- G, I and H: the candidates walked by the whole CTA ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// Block b's 9 plane rows and ids into dst (10 * bs words) as one cp.async
// group (plain copies when bs or the operands' addresses do not allow
// 16-byte ones).
__device__ void stage_block_async(const float* __restrict__ tri,
                                  const int* __restrict__ ids, int b, int bs,
                                  float* dst) {
  const float* src = tri + (size_t)b * 9 * bs;
  const int* isrc = ids + (size_t)b * bs;
  int* idst = reinterpret_cast<int*>(dst + 9 * bs);
  if (bs % 4 == 0 && (((uintptr_t)tri | (uintptr_t)ids) & 15) == 0) {
    for (int i = 4 * threadIdx.x; i < 9 * bs; i += 4 * kThreads)
      cp_async16(dst + i, src + i);
    for (int i = 4 * threadIdx.x; i < bs; i += 4 * kThreads)
      cp_async16(idst + i, isrc + i);
  } else {
    for (int i = threadIdx.x; i < 9 * bs; i += kThreads) dst[i] = src[i];
    for (int i = threadIdx.x; i < bs; i += kThreads) idst[i] = isrc[i];
  }
  cp_async_commit();
}

// The first candidate position at or after p (-1: none); bit p of the
// mask is position p: G and I plan position p = k * kSuper + j (block j
// of the k-th superblock of the tile's plan), H block p.
__device__ __forceinline__ int next_candidate(const unsigned* mask, int words,
                                              int p) {
  for (int w = p >> 5; w < words; ++w) {
    unsigned m = mask[w];
    if (w == p >> 5) m &= kFull << (p & 31);
    if (m) return 32 * w + __ffs(m) - 1;
  }
  return -1;
}

// All 32 lanes test the staged block for one pair (ray o, d on [tmin,
// tmax]), lane l taking triangles l, l + 32, ..., and end with the block's
// closest triangle on every lane: t (kF32Max if none), u, v, global id and
// slot j (kIntMax if none).  A fixed xor tree keeps the lexicographic (t,
// id, slot) minimum.
__device__ __forceinline__ void pair_closest(const float* blk, int bs,
                                             float det_eps, const float* o,
                                             const float* d, float tmin,
                                             float tmax, float* t_o,
                                             float* u_o, float* v_o,
                                             int* id_o, int* j_o) {
  const int lane = threadIdx.x & 31;
  const int* bid_s = reinterpret_cast<const int*>(blk + 9 * bs);
  float bt = kF32Max, bu = 0.0f, bv = 0.0f;
  int bid = kIntMax, bj = kIntMax;
#pragma unroll 4
  for (int j = lane; j < bs; j += kPairLanes) {
    const int id = bid_s[j];
    float u, v;
    const float t = mt(blk + j, bs, det_eps, o, d, tmin, tmax, &u, &v);
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
    if (ot < bt || (ot == bt && (oid < bid || (oid == bid && oj < bj)))) {
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

// Any hit of the staged block for one pair on [tmin, tmax], on every lane;
// the lanes test kVote triangles between votes.
__device__ __forceinline__ bool pair_any(const float* blk, int bs,
                                         float det_eps, const float* o,
                                         const float* d, float tmin,
                                         float tmax) {
  const int lane = threadIdx.x & 31;
  const int* bid_s = reinterpret_cast<const int*>(blk + 9 * bs);
  for (int j0 = 0; j0 < bs; j0 += kVote) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < kVote / kPairLanes; ++q) {
      const int j = j0 + kPairLanes * q + lane;
      if (j < bs && bid_s[j] >= 0) {
        float u, v;
        hit |= mt(blk + j, bs, det_eps, o, d, tmin, tmax, &u, &v) < kF32Max;
      }
    }
    if (__any_sync(kFull, hit)) return true;
  }
  return false;
}

// Mark position p a candidate (bit p of mask) if block box `box` passes
// the slab test of an active lane of the warp on [tmin, t1].
__device__ __forceinline__ void mark(unsigned* mask, int p, const float* box,
                                     const TileRay& r, bool active,
                                     float t1) {
  const bool pass = active && slab(box, r.o, r.inv, r.tmin, t1);
  if (__ballot_sync(kFull, pass) && (threadIdx.x & 31) == 0)
    atomicOr(&mask[p >> 5], 1u << (p & 31));
}

// The block at candidate position p: G and I, block p % kSuper of the
// plan's superblock ord[p / kSuper]; H (GATE), block p.
template <bool GATE>
__device__ __forceinline__ int block_at(const int* __restrict__ ord, int p) {
  return GATE ? p : ord[p / kSuper] * kSuper + p % kSuper;
}

// The walk's shared state besides the staged blocks: the pair list of
// the current block (the owners' threads), each pair's window and
// result, and the per-warp counts of the listing.
struct PairList {
  int lane[kThreads];
  float win[kThreads];
  float t[kThreads], u[kThreads], v[kThreads];
  int id[kThreads], j[kThreads];
  int count[kWarps];
  float red[kWarps];
};

}  // namespace

// Where a walk's candidates come from.  G and I: the tile's plan row
// (order, entry (n_tiles, num_supers): superblocks front to back and
// their entries; n_sup: the row's length).  H: the blocks of the slabs
// that gate (n_tiles / chunk_tiles, num_slabs) lets through for the
// tile's chunk, slab_blocks blocks a slab, in block order; unions
// (num_slabs, 8): each slab's union box.
struct Cands {
  const int* order;
  const float* entry;
  const int* n_sup;
  int num_supers;
  const int* gate;
  const float* unions;
  int num_slabs, slab_blocks, chunk_tiles;
};

// G (closest hit, OCC = false) and I (any hit, OCC = true) by the tile's
// front-to-back superblock plan, H (GATE) by its chunk's gated slabs; see
// the design note.  CTA c walks rays part, part + kSplit, ... of tile
// tiles[c / kSplit] (part = c % kSplit).  At least a tile's CTAs an SM:
// with no minimum ptxas held G and I to 64 registers and spilled 22-32 B,
// and I ran 7% slower (2.99-3.00 against 2.76-2.78 ms, in turns, H100
// 80GB HBM3, 700 W); with it they take 79-80.
template <bool OCC, bool GATE>
__global__ void __launch_bounds__(kThreads, kSplit)
streamed_kernel(const float* __restrict__ rays, const float* __restrict__ aabb,
                Cands cd, const int* __restrict__ tiles,
                const float* __restrict__ tri, const int* __restrict__ ids,
                int n_rays, int num_blocks, int bs, float det_eps,
                float* t_out, float* u_out, float* v_out, int* idx_out,
                unsigned char* blocked_out) {
  extern __shared__ float smem[];  // kBuffers staged blocks, the mask
  unsigned* mask = reinterpret_cast<unsigned*>(smem + kBuffers * 10 * bs);
  __shared__ PairList pl;
  const int n_pos = GATE ? num_blocks : cd.num_supers * kSuper;
  const int words = (n_pos + 31) / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = tiles[blockIdx.x / kSplit];
  const size_t ray0 = (size_t)tile * kTile + blockIdx.x % kSplit;
  const size_t gid = ray0 + kSplit * threadIdx.x;
  const TileRay r = load_ray(rays, gid);
  // lanes that cannot hit count as done in the exit tests: a zero
  // direction, and the padding past the real rays
  const bool active = r.moving && gid < (size_t)n_rays;
  const int* __restrict__ ord =
      cd.order + (GATE ? 0 : (size_t)tile * cd.num_supers);
  const float* __restrict__ ent =
      cd.entry + (GATE ? 0 : (size_t)tile * cd.num_supers);
  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};
  bool blocked = false;

  // 1. the candidates: every block whose slab test passes for some active
  // lane on its window at the start (G, H closest: [tmin, F32_MAX])
  const float start = OCC ? r.tmax : kF32Max;
  for (int w = threadIdx.x; w < words; w += kThreads) mask[w] = 0u;
  __syncthreads();
  if constexpr (GATE) {
    // a box inside a slab's union box passes no lane's slab test that the
    // union box fails, so a warp skips the slabs no lane of it may enter
    const int* __restrict__ row =
        cd.gate + (size_t)(tile / cd.chunk_tiles) * cd.num_slabs;
    for (int j = 0; j < cd.num_slabs; ++j) {
      if (!row[j] || !__any_sync(kFull, active && slab(cd.unions + 8 * j, r.o,
                                                       r.inv, r.tmin, start)))
        continue;
      const int end = min((j + 1) * cd.slab_blocks, num_blocks);
      for (int b = j * cd.slab_blocks; b < end; ++b)
        mark(mask, b, aabb + 8 * b, r, active, start);
    }
  } else {
    const int plan = cd.n_sup[tile];
    for (int k = 0; k < plan; ++k) {
      const int sb = ord[k];
      for (int j = 0; j < kSuper; ++j) {
        const int b = sb * kSuper + j;
        if (b >= num_blocks) break;
        mark(mask, k * kSuper + j, aabb + 8 * b, r, active, start);
      }
    }
  }
  __syncthreads();

  // 2. the candidates in order, the next one staged while the current
  // one is tested
  int p = next_candidate(mask, words, 0);
  if (p >= 0) stage_block_async(tri, ids, block_at<GATE>(ord, p), bs, smem);
  for (int i = 0; p >= 0; ++i) {
    const int b = block_at<GATE>(ord, p);
    const int pn = next_candidate(mask, words, p + 1);
    if (pn >= 0)
      stage_block_async(tri, ids, block_at<GATE>(ord, pn), bs,
                        smem + ((i + 1) % kBuffers) * 10 * bs);
    // the lanes whose slab test passes on their window now, and the exit
    // test: G stops once the entry exceeds every active lane's best t, I
    // and H once every active lane is blocked
    const bool pass = active && (OCC ? !blocked && slab(aabb + 8 * b, r.o,
                                                        r.inv, r.tmin, r.tmax)
                                     : slab(aabb + 8 * b, r.o, r.inv, r.tmin,
                                            h.t));
    const unsigned ball = __ballot_sync(kFull, pass);
    float open;
    if (OCC) {
      open = (float)__popc(__ballot_sync(kFull, active && !blocked));
    } else {
      open = active ? h.t : -INFINITY;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        open = fmaxf(open, __shfl_xor_sync(kFull, open, off));
    }
    if (lane == 0) {
      pl.count[warp] = __popc(ball);
      pl.red[warp] = open;
    }
    __syncthreads();
    int off = 0, total = 0;
    float m = OCC ? 0.0f : -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = pl.count[w];
      off += w < warp ? n : 0;
      total += n;
      m = OCC ? m + pl.red[w] : fmaxf(m, pl.red[w]);
    }
    // the same on every thread
    if (OCC ? m == 0.0f : !GATE && !(ent[p / kSuper] <= m)) break;
    const int q = off + __popc(ball & ((1u << lane) - 1u));
    if (pass) {
      pl.lane[q] = threadIdx.x;
      pl.win[q] = OCC ? r.tmax : h.t;
    }
    if (pn >= 0)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // the list and block b in shared memory

    // every warp takes pairs of the list in turn
    const float* blk = smem + (i % kBuffers) * 10 * bs;
    for (int e = warp; e < total; e += kWarps) {
      const float* ray = rays + 8 * (ray0 + kSplit * pl.lane[e]);
      const float o[3] = {ray[0], ray[1], ray[2]};
      const float d[3] = {ray[3], ray[4], ray[5]};
      if (OCC) {
        const bool hit = pair_any(blk, bs, det_eps, o, d, ray[6], pl.win[e]);
        if (lane == 0) pl.id[e] = hit;
      } else {
        float t, u, v;
        int id, j;
        pair_closest(blk, bs, det_eps, o, d, ray[6], pl.win[e], &t, &u, &v,
                     &id, &j);
        if (lane == 0) {
          pl.t[e] = t;
          pl.u[e] = u;
          pl.v[e] = v;
          pl.id[e] = id;
          pl.j[e] = j;
        }
      }
    }
    __syncthreads();  // the pairs' results; block b's buffer is free
    if (pass) {
      if (OCC)
        blocked = pl.id[q] != 0;
      else if (pl.j[q] != kIntMax)
        take(h, pl.t[q], pl.u[q], pl.v[q], pl.id[q], b * bs + pl.j[q]);
    }
    p = pn;
  }
  cp_async_wait<0>();  // a block staged for a walk that stopped
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

// The kernel's dynamic shared memory: *smem bytes (at most what a CTA
// may hold beside its static shared memory).
template <typename K>
int prepare(K kernel, size_t bytes, size_t* smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  *smem = bytes;
  if (bytes + attr.sharedSizeBytes > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (bytes + attr.sharedSizeBytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Launch G, I or H (the template's OCC, GATE) on n_tiles tiles.
template <bool GATE>
int launch_walk(const float* rays, const float* aabb, const Cands& cd,
                const int* tiles, const float* tri, const int* ids,
                int n_tiles, int n_rays, int num_blocks, int bs,
                float det_eps, int occluded, float* t_out, float* u_out,
                float* v_out, int* idx_out, unsigned char* blocked_out,
                cudaStream_t stream) {
  if (bs <= 0) return (int)cudaErrorInvalidValue;
  auto kernel = occluded ? &streamed_kernel<true, GATE>
                         : &streamed_kernel<false, GATE>;
  const int n_pos = GATE ? num_blocks : cd.num_supers * kSuper;
  const int words = (n_pos + 31) / 32;
  size_t smem;
  int e = prepare(kernel,
                  (size_t)kBuffers * 10 * bs * sizeof(float) +
                      (size_t)words * sizeof(unsigned),
                  &smem);
  if (e || n_tiles == 0) return e;
  kernel<<<n_tiles * kSplit, kThreads, smem, stream>>>(
      rays, aabb, cd, tiles, tri, ids, n_rays, num_blocks, bs, det_eps, t_out,
      u_out, v_out, idx_out, blocked_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// G (occluded = 0: t, u, v, idx) or I (occluded = 1: blocked_out).  rays
// (n_tiles * 512, 8), the first n_rays real; aabb (>= num_blocks, 8);
// order, entry (n_tiles, num_supers) and n_sup (n_tiles): the plan; tiles
// (n_tiles): the tiles in launch order, kSplit CTAs each; tri (>=
// num_blocks * 9, bs) and ids (>= num_blocks, bs) block-major.
int rt_streamed(const float* rays, const float* aabb, const int* order,
                const float* entry, const int* n_sup, const int* tiles,
                const float* tri, const int* ids, int n_tiles, int n_rays,
                int num_blocks, int num_supers, int bs, float det_eps,
                int occluded, float* t_out, float* u_out, float* v_out,
                int* idx_out, unsigned char* blocked_out, void* stream) {
  if (num_supers < 0) return (int)cudaErrorInvalidValue;
  const Cands cd{order, entry, n_sup, num_supers, nullptr, nullptr, 0, 0, 1};
  return launch_walk<false>(rays, aabb, cd, tiles, tri, ids, n_tiles, n_rays,
                            num_blocks, bs, det_eps, occluded, t_out, u_out,
                            v_out, idx_out, blocked_out,
                            (cudaStream_t)stream);
}

// H: rays, aabb, tiles, tri and ids as for rt_streamed; gate (n_tiles /
// chunk_tiles, num_slabs) int32, slab j holding blocks j * slab_blocks
// ..., unions (num_slabs, 8) their union boxes; occluded: write
// blocked_out, else t, u, v, idx.
int rt_blockmajor(const float* rays, const float* aabb, const int* gate,
                  const float* unions, const int* tiles, const float* tri,
                  const int* ids,
                  int n_tiles, int n_rays, int num_blocks, int num_slabs,
                  int slab_blocks, int chunk_tiles, int bs, float det_eps,
                  int occluded, float* t_out, float* u_out, float* v_out,
                  int* idx_out, unsigned char* blocked_out, void* stream) {
  if (chunk_tiles <= 0 || slab_blocks <= 0 || n_tiles % chunk_tiles ||
      num_slabs * slab_blocks < num_blocks)
    return (int)cudaErrorInvalidValue;
  const Cands cd{nullptr, nullptr, nullptr, 0, gate, unions, num_slabs,
                 slab_blocks, chunk_tiles};
  return launch_walk<true>(rays, aabb, cd, tiles, tri, ids, n_tiles, n_rays,
                           num_blocks, bs, det_eps, occluded, t_out, u_out,
                           v_out, idx_out, blocked_out, (cudaStream_t)stream);
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
