// The three TPU probe kernels of scripts/ on Hopper (sm_90a): P1, the toy
// mask of probe_toy_mask.py; P2, the one-hot attribute selection of
// probe_mm_select.py (sel7 and mm22); P3, the dynamic row reads of
// probe_dyn_reads.py (dyn12 and blk1).  None lies on a render or training
// path: each asked a question of the TPU's layout, and each answers it
// here the Hopper way.  Every kernel keeps the op order of the Pallas
// kernel and of its plain PyTorch version (probes/*.py), built with
// -fmad=false and IEEE division, so the two agree bit for bit.
//
// P1 toy_mask_kernel<MODE> replaces scripts/probe_toy_mask.py:kernel
// (pallas_call at :63).  Each (8, RT) ray block (rows 0-2 origin, 3-5
// direction, 6 distance) is one cluster of kRayRows CTAs of one thread
// per ray column; CTA `rank` of the cluster tests the block's RT rays
// against its chunk of ceil(L / 8) <= 20 boxes (staged in shared memory)
// and writes row `rank` of the block's output.  The TPU's (156, 1) VMEM
// mask is a bit a box: a thread keeps the boxes its ray enters in a word,
// each warp merges its words with one __reduce_or_sync, and one shared
// atomicOr a warp makes the CTA's chunk; each CTA then stores its chunk's
// word into every CTA of the cluster (distributed shared memory), and one
// cluster barrier later every CTA holds the block's mask: no CTA barrier
// per box, as the first port had (__syncthreads_or for each of 156
// boxes).  The slab's min and max propagate NaN, as jnp.minimum/maximum
// do (PTX min.NaN and max.NaN), so an axis with 0 * inf fails the box
// (trace_common.cuh's slab opens such an axis and is not used here).
// `scalar`/`both` loop over boxes, adding 1 to the
// block's output while the box's mask is set and any output is below 3;
// every trip adds 1 to all of the block's output, so it stays uniform
// and the loop ends with min(3, set boxes) (`scalar`: every box set,
// min(3, L)), computed here in closed form from the mask's popcount:
// the same bits (0 + 1 + 1 + 1 is exact).  `grid` alone writes mask[0]
// + dist to every row.  Bound: the launch (probe_floor_kernel, the same
// grid with nothing to do, measures it); the slab tests are 1.6e7 FP32
// operations (0.24 us of the card).
//
// P2a sel7_kernel replaces probe_mm_select.py:sel_kernel (call :86).  For
// visit k a ray's lane is w = (win + k) mod B, the sum wrapping in int32
// as JAX's does, and the TPU sums 7 masked lane reductions: each equals
// q[f, w] (one nonzero term).  One thread per ray adds q[f, w] for f < 7,
// visit after visit, from 0.0.  Bound: the chain of 28,672 dependent adds
// a thread (the sum's order is fixed), not the card's rates, so a CTA is
// one warp and the design keeps everything else off the chain's way:
// - the 7 rows are staged in shared memory (cp.async, every copy in
//   flight at once) at a fixed row stride kSelStride, each followed by
//   its first kSelStretch lanes again, so that kSelStretch visits from
//   any lane w < B read w + u without a wrap: every offset in the
//   unrolled stretch is a compile-time constant, and the lane moves on
//   once a stretch by a compare and subtract (no % in the loop);
// - the reads run kSelAhead adds ahead of the chain in a register window
//   that wraps into the next stretch (plain reads: their addresses move
//   every stretch, so ptxas has none to hoist out of the loop, as it did
//   P3's; volatile ones were 3% slower on an H100);
// - a warp's threads read one row at lanes w_t + u, so two rays whose
//   lanes agree mod 32 but differ conflict on every read.  The CTAs sort
//   the rays by that bank class (a counting sort, each CTA the same, win
//   read kSelWinChunk rays at a time through shared memory: O(rays) a
//   CTA; with the staging 8.8 us on an H100 at the script's 512 rays)
//   and deal sorted position p to warp p mod warps, lane p / warps: with
//   the script's win no warp holds more than 2 rays of a class (5 in
//   index order), 14 shared wavefronts a visit against the chain's 28
//   (the deal saves 0.047 ms of 0.13 on an H100);
// - win + k passes 2^31 - 1 at most once: the walk runs up to that visit
//   from floor_mod(win, B), then on from floor_mod(-2^31, B).
// The out of ray r goes back to out[r].

// P2b mm22_kernel replaces probe_mm_select.py:mm_kernel (call :88).  The
// TPU multiplies the (RT, B) one-hot pick, in bf16, by qsel (B, 128:
// split3's hi, mid and lo parts of 22 attributes at columns 0, 32 and
// 64) on the MXU with f32 accumulation, then adds (hi + mid) + lo per
// attribute.  The product is exact (each output has one nonzero term, a
// bf16 value times 1), so any accumulation order gives the same bits;
// only the 9 column tiles of 8 that the sums read are multiplied (cols
// 0-23, 32-55, 64-87: N = 72), over every k-step of 16 of K = B.  What
// bounds it: the product (1.55e11 FLOP at 72 columns, 0.16 ms at 989
// TFLOP/s) and the chain of 90,112 dependent adds a ray (the sum's order
// is fixed).  The chain cannot be split, so the two run apart and overlap
// in one cooperative launch (every CTA resident): a visit's product,
// spread over the card, leaves its 22 rebuilt attributes in a staging
// ring of kMmSlots visits (23 MB at 512 rays: it stays in L2) that the
// chain reads in order close behind, with flags in global memory between
// them.  The chain's CTAs come first in the grid (blockIdx < chain_ctas):
// one warp a group of 32 rays adds visit after visit, attribute after
// attribute, from a ring of kMmRing shared-memory slots that a second
// warp fills with cp.async.bulk copies of kMmRingVisits visits each (full
// and empty mbarriers), each issued once its block's products are counted
// in done[] (acquire); the filler publishes in landed[] the visits whose
// staging has landed, so that the product may overwrite their slots.
// The adding warp waits on nothing but its full barriers.  Every CTA has
// an SM to itself (180 KB of shared memory for the chain's ring), so the
// chain's adds share no SM with the product.  The product's CTAs (four
// warpgroups each, on the other SMs) stage the packed 72 columns once
// with cp.async.bulk; each warpgroup then takes
// (64-ray tile, visit) items in turn, in visit order over the grid, and
// runs wgmma.mma_async m64n72k16 with the pick as its register A fragment
// (warp w holds rows 16w..16w+15 in mma.sync's m16k16 layout; the lane's
// one-hot sits in one k-step, so a register is the thread's precomputed
// value at that step and 0 at the others), every k-step issued, in commit
// groups of kMmStageSteps with two register buffers.  The wrapper packs
// qsel's 72 columns K-major in core matrices of 8 x 16 B without swizzle
// (probes/mm_select.py pack_qsel), K padded with zero rows to kMmKBlock;
// the descriptor's leading byte offset kMmLbo steps along K, its stride
// byte offset kMmSbo along N, kMmStepBytes a k-step.  The epilogue stores
// (hi + mid) + lo as [group][slot][attribute][32 rays], then the
// warpgroup's release counts the item.
//
// P3 dyn_reads_kernel<BLOCK_MAJOR> replaces probe_dyn_reads.py:
// dyn12_kernel (call :54, rows f * 39 + b, plane-major) and blk1_kernel
// (call :56, rows b * 12 + f, block-major).  One thread per column adds
// 12 rows a visit, b = k mod 39, in a chain that cannot be split, so the
// grid stays a warp of 32 columns per CTA.  Bound: the chain of 49,152
// dependent adds a thread.  The CTA's 468 x 32-column slab (59.9 KB) is
// staged in shared memory once (cp.async, 4 bytes a column, zero-filled
// past the last column); the visit loop is unrolled over one period of
// L = 39 visits, so every row offset is a compile-time constant (no
// k mod 39, no address arithmetic), with a tail for visits mod 39; the
// reads run kDynAhead ahead of the adds in a register window that wraps
// into the next period, so the dependent adds are all the loop waits on.
// BLOCK_MAJOR changes only the constants.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRayRows = 8;     // rows of a P1 ray block, CTAs a cluster
constexpr int kMaxBoxes = 160;  // P1's (160, 1) mask scratch
constexpr int kSelRows = 7;     // P2a's masked reductions a visit
constexpr int kSelStretch = 32; // P2a: visits unrolled with fixed offsets
constexpr int kSelMaxLanes = 1024;
constexpr int kSelStride = kSelMaxLanes + kSelStretch;  // a staged row
constexpr int kSelAhead = 28;   // P2a: reads in flight ahead of the adds
constexpr int kSelBanks = 32;   // P2a: bank classes the deal spreads
constexpr int kSelWinChunk = 1024;  // P2a: rays of win staged at a time
constexpr int kDynPlanes = 12;  // P3's rows a visit
constexpr int kDynBlocks = 39;  // P3's blocks of 12 rows (L)
constexpr int kColThreads = 32;

static_assert((kMaxBoxes + kRayRows - 1) / kRayRows <= 32,
              "a CTA's chunk of boxes fits a word");
static_assert(kSelStretch == kColThreads, "a staging thread a lane past B");
static_assert(kSelRows * kSelStretch % kSelAhead == 0,
              "the window's slots repeat a stretch");

constexpr int kDynRows = kDynPlanes * kDynBlocks;  // P3's 468 rows
constexpr int kDynAhead = 26;   // P3: reads in flight ahead of the adds

constexpr int kMmAttrs = 22;       // P2b: attributes (F)
constexpr int kMmCols = 72;        // P2b: read columns, 9 tiles of 8 (N)
constexpr int kMmTileRays = 64;    // P2b: rays of a wgmma tile (M)
constexpr int kMmGroupRays = 32;   // P2b: rays of a chain warp
constexpr int kMmGroupFloats = kMmAttrs * kMmGroupRays;  // a visit's group
constexpr int kMmStageSteps = 4;   // P2b: k-steps of a commit group
constexpr int kMmKBlock = 128;     // P2b: K padded to a multiple of this
constexpr int kMmStepBytes = 2304; // P2b: a k-step's 9 x 2 core matrices
constexpr int kMmLbo = 128;        // P2b: bytes to the next core matrix in K
constexpr int kMmSbo = 256;        // P2b: bytes to the next core matrix in N
constexpr int kMmWarpgroups = 4;   // P2b: product warpgroups a CTA
constexpr int kMmThreads = 128 * kMmWarpgroups;
constexpr int kMmSlots = 512;      // P2b: visits the staging ring holds
constexpr int kMmRing = 4;         // P2b: chain copies in flight
constexpr int kMmRingVisits = 16;  // P2b: visits a chain copy (a block)
constexpr int kMmPublish = 16;     // P2b: copies between landed[] updates
constexpr int kMmRingBytes =
    kMmRing * kMmRingVisits * kMmGroupFloats * (int)sizeof(float);

static_assert(kMmStepBytes == (kMmCols / 8) * 2 * 128, "9 x 2 core matrices");
static_assert(kMmKBlock == 2 * kMmStageSteps * 16, "two register buffers");
static_assert(kMmSlots % kMmRingVisits == 0, "a copy never wraps the ring");
// the chain publishes landed[] kMmPublish copies late and lands kMmRing
// copies ahead of its adds: the ring must hold that and the product's
// window of items in flight (a few copies) besides
static_assert((kMmPublish + kMmRing + 8) * kMmRingVisits < kMmSlots,
              "the staging ring is too small for the chain's lag");

// min and max that give NaN when either side is NaN, as jnp.minimum and
// jnp.maximum do: one instruction each (sm_80 and later)
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// a mod n with the sign of n, as jnp's % on int32
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// a + b wrapping in int32, as JAX's int32 sum does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also expects `bytes` from the copies it completes
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// a wait that never ends traps (a launch error) instead of hanging the card
__device__ __forceinline__ void give_up_after(long long& tries) {
  if (++tries == (1ll << 24)) __trap();
}

// spins until the phase of parity `parity` completes
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (long long tries = 0; !done; give_up_after(tries)) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, completion on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the generic proxy's reads of shared memory before the async proxy's
// next copy into it
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accesses of x across a wgmma fence,
// commit or wait
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void pin(unsigned& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// adds `v` at p after the stores that precede it (this thread's, and those
// of the threads it synchronised with) are visible on the device
__device__ __forceinline__ void red_release(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\nred.relaxed.gpu.global.add.s32 [%0], %1;\n"
               ::"l"(p), "r"(v) : "memory");
}

// global memory written through the generic proxy (other CTAs' stores,
// acquired) before this thread's bulk copies read it
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor: no swizzle, base offset 0
__device__ __forceinline__ unsigned long long mm_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) |
         ((unsigned long long)(kMmLbo >> 4) << 16) |
         ((unsigned long long)(kMmSbo >> 4) << 32);
}

// d (+)= A (64 x 16 bf16, registers) x B (16 x 72 bf16, K-major in shared
// memory at desc); d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_m64n72(float (&d)[36],
                                             const unsigned (&a)[4],
                                             unsigned long long desc,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// cp.async of one float, zero-filled when `valid` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

}  // namespace

// MODE: 0 grid, 1 scalar, 2 both.  A cluster of kRayRows CTAs a ray
// block, CTA `rank` of it testing boxes [rank * chunk, + chunk) and
// writing row `rank`.
template <int MODE>
__global__ void __cluster_dims__(kRayRows, 1, 1)
toy_mask_kernel(const float* __restrict__ rays,
                const float* __restrict__ aabb, int n_boxes, int aabb_cols,
                float* __restrict__ out) {
  __shared__ unsigned words[kRayRows];  // the block's mask, a word a chunk
  __shared__ unsigned mine;             // this CTA's chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int rt = blockDim.x, j = threadIdx.x;
  const size_t blk = (size_t)(blockIdx.x / kRayRows) * kRayRows * rt;
  const float dist = rays[blk + 6 * rt + j];
  float v = fminf(3.0f, (float)n_boxes);  // scalar: every box set
  if (MODE != 1) {
    // arrive now, wait before the first store into another CTA: every CTA
    // of the cluster has started by then
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    __shared__ float sbox[(kMaxBoxes + kRayRows - 1) / kRayRows][6];
    const int chunk = (n_boxes + kRayRows - 1) / kRayRows;
    const int l0 = rank * chunk, nl = max(0, min(n_boxes - l0, chunk));
    for (int k = j; k < 6 * nl; k += rt)
      sbox[k / 6][k % 6] = aabb[(size_t)(l0 + k / 6) * aabb_cols + k % 6];
    if (j == 0) mine = 0u;
    const float* b = rays + blk;
    const float o[3] = {b[j], b[rt + j], b[2 * rt + j]};
    const float si[3] = {1.0f / b[3 * rt + j], 1.0f / b[4 * rt + j],
                         1.0f / b[5 * rt + j]};
    __syncthreads();
    unsigned bits = 0u;  // bit l: this thread's ray enters box l0 + l
#pragma unroll 4
    for (int l = 0; l < nl; ++l) {
      float t0 = 1e-4f, t1 = dist;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float lo = (sbox[l][a] - o[a]) * si[a];
        const float hi = (sbox[l][a + 3] - o[a]) * si[a];
        t0 = nan_max(t0, nan_min(lo, hi));
        t1 = nan_min(t1, nan_max(lo, hi));
      }
      bits |= (unsigned)(t0 <= t1) << l;
    }
    // the warp's vote (a last warp of RT % 32 threads votes alone)
    bits = __reduce_or_sync(__activemask(), bits);
    if ((j & 31) == 0 && bits) atomicOr(&mine, bits);
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    // thread j stores into CTAs j, j + RT, ...: every CTA gets the word
    // for any RT, fewer than kRayRows included
    for (int c = j; c < kRayRows; c += rt)
      *cluster.map_shared_rank(&words[rank], c) = mine;
    cluster.sync();  // every CTA's words[] holds the whole mask
    if (MODE == 2) {
      int set = 0;
#pragma unroll
      for (int c = 0; c < kRayRows; ++c) set += __popc(words[c]);
      v = (float)min(3, set);
    } else {
      v = ((words[0] & 1u) ? 1.0f : 0.0f) + dist;
    }
  }
  out[blk + (size_t)rank * rt + j] = v;
}

// The launch floor of P1: the same grid (clusters of CLUSTER CTAs) with
// nothing to do.
template <int CLUSTER>
__global__ void __cluster_dims__(CLUSTER, 1, 1) probe_floor_kernel() {}

// P2a's staging: row f of q at f * kSelStride, lanes x < B + kSelStretch
// holding q[f, x mod B]; every copy in flight at once (cp.async), waited
// for by the caller.  A CTA is kSelStretch threads: one lane past B each.
__device__ __forceinline__ void sel7_stage(float* sq,
                                           const float* __restrict__ q,
                                           int lanes) {
  const int t = threadIdx.x, past = t < lanes ? t : t % lanes;
  for (int f = 0; f < kSelRows; ++f) {
    for (int x = t; x < lanes; x += kSelStretch)
      cp_async4(sq + f * kSelStride + x, q + f * lanes + x, true);
    cp_async4(sq + f * kSelStride + lanes + t, q + f * lanes + past, true);
  }
}

// a lane's bank class: floor_mod(w, lanes) mod 32, without a division
// when lanes is a power of two
__device__ __forceinline__ int bank_class(int w, int lanes) {
  const int m = (lanes & (lanes - 1)) == 0 ? w & (lanes - 1)
                                           : floor_mod(w, lanes);
  return m & (kSelBanks - 1);
}

// win[base ..] into swin, up to kSelWinChunk rays (waits for every copy
// this thread has in flight)
__device__ __forceinline__ int sel7_win_chunk(int* swin,
                                              const int* __restrict__ win,
                                              int base, int n_rays) {
  const int m = min(kSelWinChunk, n_rays - base);
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    cp_async4(reinterpret_cast<float*>(swin + i),
              reinterpret_cast<const float*>(win + base + i), true);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  return m;
}

// P2a's walk: n visits from lane w (0 <= w < lanes) added onto acc, read
// i = 7u + f of a stretch at s[w + f * kSelStride + u]; `step` is
// kSelStretch mod lanes
__device__ __forceinline__ float sel7_walk(const float* s, int w, int n,
                                           int lanes, int step, float acc) {
  constexpr int kReads = kSelRows * kSelStretch;
  float x[kSelAhead];  // reads i .. i + kSelAhead - 1 of the stretch
#pragma unroll
  for (int i = 0; i < kSelAhead; ++i)
    x[i] = s[w + (i % kSelRows) * kSelStride + i / kSelRows];
  const int stretches = n / kSelStretch;
  for (int t = 0; t < stretches; ++t) {
    int wn = w + step;
    if (wn >= lanes) wn -= lanes;
#pragma unroll
    for (int i = 0; i < kReads; ++i) {
      const float v = x[i % kSelAhead];
      const int j = (i + kSelAhead) % kReads;
      x[i % kSelAhead] =
          s[(i + kSelAhead < kReads ? w : wn) + (j % kSelRows) * kSelStride +
            j / kSelRows];
      acc = acc + v;
    }
    w = wn;
  }
  for (int u = 0; u < n - stretches * kSelStretch; ++u) {
#pragma unroll
    for (int f = 0; f < kSelRows; ++f) acc = acc + s[w + f * kSelStride + u];
  }
  return acc;
}

__global__ void __launch_bounds__(kColThreads)
sel7_kernel(const int* __restrict__ win, const float* __restrict__ q,
            int n_rays, int lanes, int visits, float* __restrict__ out) {
  __shared__ float sq[kSelRows * kSelStride];
  __shared__ int swin[kSelWinChunk];  // a chunk of win
  __shared__ int next[kSelBanks];     // the counting sort's cursor a class
  __shared__ int mine[kColThreads];   // the rays dealt to this warp
  const int lane = threadIdx.x, warps = gridDim.x;
  sel7_stage(sq, q, lanes);
  // the deal: class c = floor_mod(win, lanes) mod 32; ray i's sorted
  // position is the rays of lower classes, then of its class before it
  const unsigned lt = (1u << lane) - 1u;
  next[lane] = 0;
  for (int base = 0; base < n_rays; base += kSelWinChunk) {
    const int m = sel7_win_chunk(swin, win, base, n_rays);
    for (int i = lane; i < m; i += 32)
      atomicAdd(&next[bank_class(swin[i], lanes)], 1);
    __syncwarp();
  }
  const int count = next[lane];  // the rays of class `lane`
  int start = count;  // an exclusive scan over the 32 classes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(~0u, start, d);
    if (lane >= d) start += y;
  }
  next[lane] = start - count;
  __syncwarp();
  for (int base = 0; base < n_rays; base += kSelWinChunk) {
    // one chunk: still in swin
    const int m = n_rays <= kSelWinChunk
                      ? n_rays
                      : sel7_win_chunk(swin, win, base, n_rays);
    for (int c0 = 0; c0 < m; c0 += 32) {
      const int i = c0 + lane;
      const int c = i < m ? bank_class(swin[i], lanes) : kSelBanks;
      const unsigned peers = __match_any_sync(~0u, c);
      const int pos = c < kSelBanks ? next[c] + __popc(peers & lt) : 0;
      __syncwarp();
      if (c < kSelBanks) {
        if ((peers & lt) == 0u) next[c] += __popc(peers);
        if (pos % warps == (int)blockIdx.x) mine[pos / warps] = base + i;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (lane * warps + (int)blockIdx.x >= n_rays) return;
  const int r = mine[lane];
  const int wv = win[r];
  // visits before win + k passes 2^31 - 1 (all of them for win <= 0)
  const long long room = wv > 0 ? (1ll << 31) - wv : (long long)visits;
  const int n1 = (int)(room < visits ? room : visits);
  const int step = kSelStretch % lanes, w1 = floor_mod(INT_MIN, lanes);
  float acc = 0.0f;
  int w = floor_mod(wv, lanes), n = n1;
#pragma unroll 1
  for (int seg = 0; seg < 2; ++seg) {
    acc = sel7_walk(sq, w, n, lanes, step, acc);
    w = w1;
    n = visits - n1;
  }
  out[r] = acc;
}

// P2b's chain, warp-specialised: warp 0 of CTA `grp` adds its 32 rays'
// attributes of every visit onto each ray's sum in order, from a ring of
// kMmRing shared-memory slots that warp 1 fills.  Copy i brings visits
// 16i .. 16i + 15 (ring slot i mod kMmRing, staging slot 16i mod
// kMmSlots) once their block is multiplied (done[i] counts its (tile,
// visit) items; not waited for when `wait` is 0) and its slot is empty;
// every kMmPublish copies the filler publishes in landed[grp] the visits
// whose staging has landed (their staging slots may be overwritten).  The
// adding warp only waits on the full barriers and arrives on the empty
// ones.
__device__ __forceinline__ void mm22_chain(
    unsigned char* smem, int grp, int n_rays, int visits, int n_tiles,
    bool wait, const float* stage, const int* done, int* landed,
    float* __restrict__ out) {
  constexpr int kCopy = kMmRingVisits * kMmGroupFloats;  // floats a copy
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* ring = reinterpret_cast<const float*>(smem);
  const unsigned ring0 = smem_u32(smem), full0 = ring0 + kMmRingBytes;
  const unsigned empty0 = full0 + 8 * kMmRing;
  const int copies = (visits + kMmRingVisits - 1) / kMmRingVisits;
  auto visits_of = [&](int i) {
    return min(kMmRingVisits, visits - i * kMmRingVisits);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMmRing; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, 1);
    }
  }
  asm volatile("bar.sync 1, 64;\n" ::: "memory");  // warps 0 and 1
  if (warp == 1) {
    if (lane != 0) return;
    const float* src = stage + (size_t)grp * kMmSlots * kMmGroupFloats;
    for (int i = 0; i < copies; ++i) {
      const int slot = i % kMmRing;
      if (i >= kMmRing) {
        mbar_wait(empty0 + 8 * slot, (i / kMmRing - 1) & 1);
        const int freed = i - kMmRing;  // copy consumed, its visits landed
        if (freed % kMmPublish == kMmPublish - 1)
          st_release(landed + grp, (freed + 1) * kMmRingVisits);
      }
      for (long long tries = 0;
           wait && ld_acquire(done + i) < n_tiles * visits_of(i);
           give_up_after(tries))
        __nanosleep(64);
      fence_async_global();
      fence_async_shared();
      const unsigned bytes = visits_of(i) * kMmGroupFloats * sizeof(float);
      mbar_expect(full0 + 8 * slot, bytes);
      bulk_load(ring0 + slot * kCopy * sizeof(float),
                src + (size_t)(i * kMmRingVisits % kMmSlots) * kMmGroupFloats,
                bytes, full0 + 8 * slot);
    }
    return;
  }
  const int r = grp * kMmGroupRays + lane;
  float acc = 0.0f;
  for (int i = 0; i < copies; ++i) {
    const int slot = i % kMmRing;
    mbar_wait(full0 + 8 * slot, (i / kMmRing) & 1);
    const float* b = ring + slot * kCopy + lane;
    if (visits_of(i) == kMmRingVisits) {
#pragma unroll
      for (int j = 0; j < kMmRingVisits * kMmAttrs; ++j)
        acc = acc + b[j * kMmGroupRays];
    } else {
      for (int j = 0; j < visits_of(i) * kMmAttrs; ++j)
        acc = acc + b[j * kMmGroupRays];
    }
    __syncwarp();  // every lane has read the slot
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
  }
  if (r < n_rays) out[r] = acc;
}

// P2b's product: the CTA stages the packed columns once, then each
// warpgroup multiplies (64-ray tile, visit) items in turn, in visit order
// over the grid, stores (hi + mid) + lo of each ray and attribute in ring
// slot v mod kMmSlots (once the chain has landed that slot's last visit,
// when `wait` is set) and counts the item in done[v / kMmRingVisits].
__device__ __forceinline__ void mm22_product(
    unsigned char* smem, int cta, int n_ctas, const int* __restrict__ win,
    const unsigned short* __restrict__ qpack, int n_rays, int lanes,
    int ksteps, int visits, bool wait, float* __restrict__ stage, int* done,
    const int* landed) {
  constexpr int kBlockBytes = kMmKBlock / 16 * kMmStepBytes;
  const unsigned qbytes = ksteps * kMmStepBytes;
  const unsigned b0 = smem_u32(smem), bar = b0 + qbytes;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_expect(bar, qbytes);
    for (unsigned off = 0; off < qbytes; off += kBlockBytes)
      bulk_load(b0 + off, reinterpret_cast<const unsigned char*>(qpack) + off,
                kBlockBytes, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int n_tiles = (n_rays + kMmTileRays - 1) / kMmTileRays;
  const int items = n_tiles * visits;
  const unsigned long long desc0 = mm_desc(b0);
  const size_t grp_stride = (size_t)kMmSlots * kMmGroupFloats;
  float d[36];
#pragma unroll
  for (int i = 0; i < 36; ++i) d[i] = 0.0f;
  unsigned a[2][kMmStageSteps][4];
  int seen = 0;  // visits the chain of this warp's group has landed
  for (int it = cta * kMmWarpgroups + wg; it < items;
       it += n_ctas * kMmWarpgroups) {
    const int tile = it % n_tiles, v = it / n_tiles;
    const int r0 = tile * kMmTileRays + 16 * warp + g, r1 = r0 + 8;
    const int p0 =
        r0 < n_rays ? floor_mod(wrap_add(win[r0], v), lanes) : -1;
    const int p1 =
        r1 < n_rays ? floor_mod(wrap_add(win[r1], v), lanes) : -1;
    // the pick's A fragment: a row's lane p sits at k-step p >> 4, column
    // p & 15 of it (no k-step for p = -1); thread q holds columns 2q and
    // 2q + 1 (register 0 row g, register 1 row g + 8) and 2q + 8, 2q + 9
    // (registers 2 and 3), the first column in the lower half; bf16 1.0
    // is 0x3f80
    const int s0 = p0 >> 4, s1 = p1 >> 4;
    const int c0 = (p0 & 15) >> 1, c1 = (p1 & 15) >> 1;
    const unsigned one0 = (p0 & 1) ? 0x3f800000u : 0x3f80u;
    const unsigned one1 = (p1 & 1) ? 0x3f800000u : 0x3f80u;
    const unsigned v0 = c0 == q ? one0 : 0u, v2 = c0 == q + 4 ? one0 : 0u;
    const unsigned v1 = c1 == q ? one1 : 0u, v3 = c1 == q + 4 ? one1 : 0u;
#pragma unroll
    for (int i = 0; i < 36; ++i) pin(d[i]);
    for (int st = 0; st < ksteps; st += 2 * kMmStageSteps) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sb = st + h * kMmStageSteps;
        wg_wait<1>();  // the group that last read a[h] is done
#pragma unroll
        for (int j = 0; j < kMmStageSteps; ++j) {
          a[h][j][0] = sb + j == s0 ? v0 : 0u;
          a[h][j][1] = sb + j == s1 ? v1 : 0u;
          a[h][j][2] = sb + j == s0 ? v2 : 0u;
          a[h][j][3] = sb + j == s1 ? v3 : 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e) pin(a[h][j][e]);
        }
        wg_fence();
#pragma unroll
        for (int j = 0; j < kMmStageSteps; ++j)
          wgmma_m64n72(d, a[h][j],
                       desc0 + (unsigned long long)((sb + j) *
                                                    (kMmStepBytes >> 4)),
                       sb + j > 0);
        wg_commit();
      }
    }
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 36; ++i) pin(d[i]);
    // the warp's 16 rows lie in one chain group; its slot must be free
    const int row0 = tile * kMmTileRays + 16 * warp;
    for (long long tries = 0; wait && row0 < n_rays && v - kMmSlots >= seen;
         give_up_after(tries)) {
      seen = ld_acquire(landed + row0 / kMmGroupRays);
      if (v - kMmSlots >= seen) __nanosleep(256);
    }
    // d[4j + e] is (row g, column 8j + 2q + e), d[4j + 2 + e] row g + 8;
    // tile j < 3 holds hi, 3 + j mid and 6 + j lo of attribute
    // f = 8j + 2q + e (columns 22 and 23 of a part are padding)
    float* dst = stage + (size_t)(v % kMmSlots) * kMmGroupFloats;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = 8 * j + 2 * q + e;
        if (f >= kMmAttrs) continue;
        if (r0 < n_rays)
          dst[r0 / kMmGroupRays * grp_stride + f * kMmGroupRays +
              r0 % kMmGroupRays] =
              (d[4 * j + e] + d[4 * (3 + j) + e]) + d[4 * (6 + j) + e];
        if (r1 < n_rays)
          dst[r1 / kMmGroupRays * grp_stride + f * kMmGroupRays +
              r1 % kMmGroupRays] =
              (d[4 * j + 2 + e] + d[4 * (3 + j) + 2 + e]) +
              d[4 * (6 + j) + 2 + e];
      }
    }
    // the warpgroup's stores, then one release of the item
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0) red_release(done + v / kMmRingVisits, 1);
  }
}

// P2b in one cooperative launch, every CTA resident: CTAs below
// chain_ctas run the chain of their group of 32 rays, the others the
// product.  parts: 1 the product alone, 2 the chain alone (neither waits
// for the other; the staging then holds what it holds), 3 both.
__global__ void __launch_bounds__(kMmThreads, 1)
mm22_kernel(const int* __restrict__ win,
            const unsigned short* __restrict__ qpack, int n_rays, int lanes,
            int ksteps, int visits, int chain_ctas, int parts, float* stage,
            int* done, int* landed, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_tiles = (n_rays + kMmTileRays - 1) / kMmTileRays;
  if ((int)blockIdx.x < chain_ctas) {
    if (threadIdx.x < 64)
      mm22_chain(smem, blockIdx.x, n_rays, visits, n_tiles, parts & 1, stage,
                 done, landed, out);
    return;
  }
  mm22_product(smem, blockIdx.x - chain_ctas, gridDim.x - chain_ctas, win,
               qpack, n_rays, lanes, ksteps, visits, parts & 2, stage, done,
               landed);
}

// the i-th read of a P3 period: visit b = i / 12, plane f = i mod 12
template <bool BLOCK_MAJOR>
__host__ __device__ constexpr int dyn_row(int i) {
  return BLOCK_MAJOR ? i : (i % kDynPlanes) * kDynBlocks + i / kDynPlanes;
}

static_assert(kDynRows % kDynAhead == 0, "the window's slots repeat a period");

template <bool BLOCK_MAJOR>
__global__ void __launch_bounds__(kColThreads)
dyn_reads_kernel(const float* __restrict__ q, int lanes, int visits,
                 float* __restrict__ out) {
  extern __shared__ float slab[];  // [row][kColThreads columns]
  const int lane = threadIdx.x, c = blockIdx.x * kColThreads + lane;
  const bool valid = c < lanes;
  const float* col = q + (valid ? c : 0);
  for (int row = 0; row < kDynRows; ++row)
    cp_async4(slab + row * kColThreads + lane, col + (size_t)row * lanes,
              valid);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // a thread reads back only what it copied: no barrier.  The reads are
  // volatile: the slab does not change, and the compiler would otherwise
  // hoist all 468 of them out of the period loop (into spilled registers)
  const volatile float* s = slab + lane;
  float x[kDynAhead];  // reads i .. i + kDynAhead - 1 of the period
#pragma unroll
  for (int i = 0; i < kDynAhead; ++i)
    x[i] = s[dyn_row<BLOCK_MAJOR>(i) * kColThreads];
  float acc = 0.0f;
  const int periods = visits / kDynBlocks;
  for (int p = 0; p < periods; ++p) {
#pragma unroll
    for (int i = 0; i < kDynRows; ++i) {
      const float v = x[i % kDynAhead];
      x[i % kDynAhead] =
          s[dyn_row<BLOCK_MAJOR>((i + kDynAhead) % kDynRows) * kColThreads];
      acc = acc + v;
    }
  }
  const int tail = (visits - periods * kDynBlocks) * kDynPlanes;
#pragma unroll 4
  for (int i = 0; i < tail; ++i)
    acc = acc + s[dyn_row<BLOCK_MAJOR>(i) * kColThreads];
  if (valid) out[c] = acc;
}

// ---- C interface (loaded with ctypes) ----

extern "C" {

int rt_toy_mask(int mode, const float* rays, const float* aabb, int n_blocks,
                int rt, int n_boxes, int aabb_cols, float* out, void* stream) {
  if (n_blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int ctas = n_blocks * kRayRows;
  if (mode == 0)
    toy_mask_kernel<0><<<ctas, rt, 0, s>>>(rays, aabb, n_boxes, aabb_cols,
                                           out);
  else if (mode == 1)
    toy_mask_kernel<1><<<ctas, rt, 0, s>>>(rays, aabb, n_boxes, aabb_cols,
                                           out);
  else
    toy_mask_kernel<2><<<ctas, rt, 0, s>>>(rays, aabb, n_boxes, aabb_cols,
                                           out);
  return (int)cudaGetLastError();
}

// an empty launch of `ctas` CTAs of `threads`, in clusters of 1 or
// kRayRows (P1's grid): the floor under a probe's device time
int rt_probe_floor(int ctas, int threads, int cluster, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == kRayRows)
    probe_floor_kernel<kRayRows><<<ctas, threads, 0, s>>>();
  else
    probe_floor_kernel<1><<<ctas, threads, 0, s>>>();
  return (int)cudaGetLastError();
}

int rt_sel7(const int* win, const float* q, int n_rays, int lanes, int visits,
            float* out, void* stream) {
  if (n_rays == 0) return 0;
  // every array is static (33,920 B of shared memory at any lanes)
  sel7_kernel<<<(n_rays + kColThreads - 1) / kColThreads, kColThreads, 0,
                (cudaStream_t)stream>>>(win, q, n_rays, lanes, visits, out);
  return (int)cudaGetLastError();
}

// P2b: one cooperative launch of ceil(n_rays / 32) chain CTAs and as many
// product CTAs as stay resident beside them; parts: 1 the product alone,
// 2 the chain alone, 3 both.  `stage` holds ceil(n_rays / 32) x kMmSlots
// x 22 x 32 floats, `counters` (zeroed) ceil(visits / 8) + ceil(n_rays /
// 32) ints; qpack holds ksteps k-steps of kMmStepBytes (ksteps a multiple
// of kMmKBlock / 16).
int rt_mm22(const int* win, const unsigned short* qpack, int n_rays, int lanes,
            int ksteps, int visits, float* stage, int* counters, float* out,
            int parts, void* stream) {
  if (n_rays == 0) return 0;
  // the device's resident CTAs at this shared memory size, kept per
  // (device, size) for the next call
  static int cached_dev = -1, sms = 0, per_sm = 0;
  static size_t cached_smem = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const size_t qbytes = (size_t)ksteps * kMmStepBytes;
  const size_t smem =
      (qbytes > (size_t)kMmRingBytes ? qbytes : (size_t)kMmRingBytes) +
      16 * kMmRing;
  if (err == cudaSuccess && (dev != cached_dev || smem != cached_smem)) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          mm22_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mm22_kernel, kMmThreads, smem);
    cached_dev = err == cudaSuccess ? dev : -1;
    cached_smem = smem;
  }
  if (err != cudaSuccess) return (int)err;
  const int groups = (n_rays + kMmGroupRays - 1) / kMmGroupRays;
  int chain_ctas = (parts & 2) ? groups : 0;
  const int prod_ctas = (parts & 1) ? per_sm * sms - chain_ctas : 0;
  if (prod_ctas < 0 || ((parts & 1) && prod_ctas == 0))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  int* done = counters;
  int* landed = counters + (visits + kMmRingVisits - 1) / kMmRingVisits;
  void* args[] = {&win,   &qpack,      &n_rays, &lanes, &ksteps, &visits,
                  &chain_ctas, &parts, &stage,  &done,  &landed, &out};
  err = cudaLaunchCooperativeKernel((const void*)mm22_kernel,
                                    dim3(chain_ctas + prod_ctas),
                                    dim3(kMmThreads), args, smem,
                                    (cudaStream_t)stream);
  return (int)err;
}

int rt_dyn_reads(int block_major, const float* q, int lanes, int visits,
                 float* out, void* stream) {
  if (lanes == 0) return 0;
  const int grid = (lanes + kColThreads - 1) / kColThreads;
  const size_t smem = (size_t)kDynRows * kColThreads * sizeof(float);
  void (*kern)(const float*, int, int, float*) =
      block_major ? dyn_reads_kernel<true> : dyn_reads_kernel<false>;
  static int set_on[2] = {-1, -1};  // the device each kernel's size is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && set_on[block_major != 0] != dev) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    set_on[block_major != 0] = err == cudaSuccess ? dev : -1;
  }
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kColThreads, smem, (cudaStream_t)stream>>>(q, lanes, visits,
                                                          out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
