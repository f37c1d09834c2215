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
// (pallas_call at :63).  One CTA of one thread per ray column for each
// (8, RT) ray block (rows 0-2 origin, 3-5 direction, 6 distance).  `grid`:
// each thread runs its ray's slab test against every box, and the CTA
// reduces "any ray enters box l" with __syncthreads_or into a shared mask
// (the TPU's (156, 1) VMEM scratch).  The slab's min and max propagate
// NaN, as jnp.minimum/maximum do, so an axis with 0 * inf fails the box;
// trace_common.cuh's slab opens such an axis and is not used here.
// `scalar`/`both`: a loop over boxes that adds 1 to the block's output
// while the box's mask is set and any output is below 3, the CTA-wide
// "any" taken again on each trip (__syncthreads_or).  Every trip adds 1
// to all of the block's output, so it stays uniform over the block and a
// thread keeps its 8 rows in one register.  `grid` alone writes mask[0]
// + dist to every row.  Bound: a few microseconds of launch; the slab
// tests are 1.6e7 FP32 operations (0.24 us of the card).
//
// P2a sel7_kernel replaces probe_mm_select.py:sel_kernel (call :86).  For
// visit k a ray's lane is w = (win + k) mod B, and the TPU sums 7 masked
// lane reductions: each equals q[f, w] (one nonzero term).  One thread
// per ray adds q[f, w] for f < 7, visit after visit, from the 7 rows
// staged in shared memory.  Bound: the chain of 28,672 dependent adds a
// thread (the sum's order is fixed), not the card's rates.
//
// P2b mm22_kernel replaces probe_mm_select.py:mm_kernel (call :88).  The
// TPU multiplies the (RT, B) one-hot pick, in bf16, by qsel (B, 128:
// split3's hi, mid and lo parts of 22 attributes at columns 0, 32 and
// 64) on the MXU with f32 accumulation, then adds (hi + mid) + lo per
// attribute.  Here the product runs on the tensor cores with warp-level
// mma.sync m16n8k16 (bf16 in, f32 accumulation), the pick built in
// registers as the A fragment, qsel staged once per CTA in shared memory
// in B-fragment order.  Only the 9 column tiles of 8 that the sums read
// are multiplied (cols 0-23, 32-55, 64-87); the other 56 columns of qsel
// are zero padding.  The product is exact: each output has one nonzero
// term, a bf16 value times 1.  A CTA holds 16 rays; each of its 8 warps
// computes one visit of a group of 8 and leaves the 22 rebuilt attributes
// in shared memory, and 16 threads add them into the rays' sums in visit
// order (double-buffered: one __syncthreads a group).  Bound: the
// tensor-core product (1.4e11 FLOP of the read columns, 0.14 ms at 989
// TFLOP/s) and the chain of 90,112 dependent adds a ray.
//
// P3 dyn_reads_kernel<BLOCK_MAJOR> replaces probe_dyn_reads.py:
// dyn12_kernel (call :54, rows f * 39 + b, plane-major) and blk1_kernel
// (call :56, rows b * 12 + f, block-major).  One thread per column adds
// 12 rows a visit, b = k mod 39.  A CTA of 32 columns reads a 128-byte
// slice of each of the 468 rows (60 KB, resident in L1 after the first
// visits), so both layouts read the same lines and the order of the reads
// is the only difference.  Bound: the chain of 49,152 dependent adds a
// thread.

#include <cuda_runtime.h>

namespace {

constexpr int kRayRows = 8;     // rows of a P1 ray block
constexpr int kMaxBoxes = 160;  // P1's (160, 1) mask scratch
constexpr int kSelRows = 7;     // P2a's masked reductions a visit
constexpr int kDynPlanes = 12;  // P3's rows a visit
constexpr int kDynBlocks = 39;  // P3's blocks of 12 rows (L)
constexpr int kColThreads = 32;

constexpr int kMmWarps = 8;    // P2b: visits of a group, one a warp
constexpr int kMmRays = 16;    // P2b: rays of a CTA (mma's M)
constexpr int kMmTiles = 9;    // P2b: column tiles of 8 the sums read
constexpr int kMmAttrs = 22;   // P2b: attributes (F)
constexpr int kMmSlots = 24;   // P2b: 3 tiles of 8 columns a part
constexpr int kMmStride = kMmSlots + 1;  // P2b: attribute buffer's row

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// (a + k) mod n with the sign of n, as jnp's % on int32
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// two bf16 one-hot entries (cols c, c + 1 of a pick row whose lane is p):
// bf16 1.0 is 0x3f80, the lower half the first column
__device__ __forceinline__ unsigned pick2(int p, int c) {
  return (p == c ? 0x3f80u : 0u) | (p == c + 1 ? 0x3f800000u : 0u);
}

// first column of P2b's column tile j: hi 0, 8, 16; mid 32, 40, 48; lo 64..
__device__ __forceinline__ int tile_col(int j) {
  return (j / 3) * 32 + (j % 3) * 8;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace

// MODE: 0 grid, 1 scalar, 2 both
template <int MODE>
__global__ void toy_mask_kernel(const float* __restrict__ rays,
                                const float* __restrict__ aabb, int n_boxes,
                                int aabb_cols, float* __restrict__ out) {
  __shared__ float smask[kMaxBoxes];
  const int rt = blockDim.x, j = threadIdx.x;
  const float* blk = rays + (size_t)blockIdx.x * kRayRows * rt;
  const float o[3] = {blk[j], blk[rt + j], blk[2 * rt + j]};
  const float si[3] = {1.0f / blk[3 * rt + j], 1.0f / blk[4 * rt + j],
                       1.0f / blk[5 * rt + j]};
  const float dist = blk[6 * rt + j];
  if (MODE != 1) {
    for (int l = 0; l < n_boxes; ++l) {
      const float* box = aabb + (size_t)l * aabb_cols;
      float t0 = 1e-4f, t1 = dist;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float lo = (box[a] - o[a]) * si[a];
        const float hi = (box[a + 3] - o[a]) * si[a];
        t0 = nan_max(t0, nan_min(lo, hi));
        t1 = nan_min(t1, nan_max(lo, hi));
      }
      const int any = __syncthreads_or(t0 <= t1);
      if (j == 0) smask[l] = any ? 1.0f : 0.0f;
    }
  } else {
    for (int l = j; l < kMaxBoxes; l += rt) smask[l] = 1.0f;
  }
  __syncthreads();
  float v = 0.0f;  // the block's output, the same in all 8 rows
  if (MODE != 0) {
    for (int k = 0; k < n_boxes && __syncthreads_or(v < 3.0f); ++k)
      if (smask[k] > 0.0f) v = v + 1.0f;
  } else {
    v = smask[0] + dist;
  }
  float* ob = out + (size_t)blockIdx.x * kRayRows * rt;
#pragma unroll
  for (int r = 0; r < kRayRows; ++r) ob[r * rt + j] = v;
}

__global__ void __launch_bounds__(kColThreads)
sel7_kernel(const int* __restrict__ win, const float* __restrict__ q,
            int n_rays, int lanes, int visits, float* __restrict__ out) {
  extern __shared__ float sq[];  // q's first 7 rows
  for (int i = threadIdx.x; i < kSelRows * lanes; i += blockDim.x)
    sq[i] = q[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const int w0 = win[r];
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < visits; ++k) {
    const int w = floor_mod(w0 + k, lanes);
#pragma unroll
    for (int f = 0; f < kSelRows; ++f) acc = acc + sq[f * lanes + w];
  }
  out[r] = acc;
}

__global__ void __launch_bounds__(kMmWarps * 32)
mm22_kernel(const int* __restrict__ win,
            const unsigned short* __restrict__ qsel, int lanes, int qcols,
            int visits, float* __restrict__ out) {
  extern __shared__ uint2 smem[];
  const int ksteps = lanes / 16;
  uint2* bfrag = smem;  // [ksteps][kMmTiles][32 lanes]
  float* abuf = reinterpret_cast<float*>(bfrag + ksteps * kMmTiles * 32);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  // qsel in B-fragment order: lane (g, qd) of tile j at k-step s holds
  // rows 16 s + 2 qd + {0, 1} and + {8, 9} of column tile_col(j) + g
  for (int i = tid; i < ksteps * kMmTiles * 32; i += blockDim.x) {
    const int ln = i & 31, j = (i >> 5) % kMmTiles, s = (i >> 5) / kMmTiles;
    const unsigned short* col = qsel + tile_col(j) + (ln >> 2);
    const int k0 = 16 * s + 2 * (ln & 3);
    uint2 v;
    v.x = col[(size_t)k0 * qcols] |
          ((unsigned)col[(size_t)(k0 + 1) * qcols] << 16);
    v.y = col[(size_t)(k0 + 8) * qcols] |
          ((unsigned)col[(size_t)(k0 + 9) * qcols] << 16);
    bfrag[i] = v;
  }
  const int ray0 = blockIdx.x * kMmRays;
  const int w_lo = win[ray0 + g], w_hi = win[ray0 + g + 8];
  float acc = 0.0f;  // threads 0-15: ray ray0 + tid
  __syncthreads();
  const int groups = (visits + kMmWarps - 1) / kMmWarps;
  for (int c = 0; c < groups; ++c) {
    float* ab = abuf + (c & 1) * kMmWarps * kMmRays * kMmStride;
    const int k = c * kMmWarps + warp;
    if (k < visits) {
      const int p0 = floor_mod(w_lo + k, lanes);
      const int p1 = floor_mod(w_hi + k, lanes);
      float d[kMmTiles][4];
#pragma unroll
      for (int j = 0; j < kMmTiles; ++j)
        d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.0f;
      for (int s = 0; s < ksteps; ++s) {
        const int col = 16 * s + 2 * qd;
        const unsigned a0 = pick2(p0, col), a1 = pick2(p1, col);
        const unsigned a2 = pick2(p0, col + 8), a3 = pick2(p1, col + 8);
        const uint2* b = bfrag + s * kMmTiles * 32 + lane;
#pragma unroll
        for (int j = 0; j < kMmTiles; ++j) {
          const uint2 bj = b[j * 32];
          mma_bf16(d[j], a0, a1, a2, a3, bj.x, bj.y);
        }
      }
      // slot f = 8 t + 2 qd + e: hi in tile t, mid in 3 + t, lo in 6 + t,
      // all three in this thread (element e; rows g and g + 8); slots 22
      // and 23 are stored and never added
#pragma unroll
      for (int t = 0; t < 3; ++t) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 8 * t + 2 * qd + e;
          ab[(warp * kMmRays + g) * kMmStride + f] =
              (d[t][e] + d[3 + t][e]) + d[6 + t][e];
          ab[(warp * kMmRays + g + 8) * kMmStride + f] =
              (d[t][2 + e] + d[3 + t][2 + e]) + d[6 + t][2 + e];
        }
      }
    }
    __syncthreads();
    if (tid < kMmRays) {  // a visit's loads issued before its adds
      const int nw = min(kMmWarps, visits - c * kMmWarps);
      for (int w = 0; w < nw; ++w) {
        const float* row = ab + (w * kMmRays + tid) * kMmStride;
        float a[kMmAttrs];
#pragma unroll
        for (int f = 0; f < kMmAttrs; ++f) a[f] = row[f];
#pragma unroll
        for (int f = 0; f < kMmAttrs; ++f) acc = acc + a[f];
      }
    }
  }
  if (tid < kMmRays) out[ray0 + tid] = acc;
}

template <bool BLOCK_MAJOR>
__global__ void __launch_bounds__(kColThreads)
dyn_reads_kernel(const float* __restrict__ q, int lanes, int visits,
                 float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= lanes) return;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < visits; ++k) {
    const int b = k % kDynBlocks;
#pragma unroll
    for (int f = 0; f < kDynPlanes; ++f) {
      const int row = BLOCK_MAJOR ? b * kDynPlanes + f : f * kDynBlocks + b;
      acc = acc + q[(size_t)row * lanes + c];
    }
  }
  out[c] = acc;
}

// ---- C interface (loaded with ctypes) ----

extern "C" {

int rt_toy_mask(int mode, const float* rays, const float* aabb, int n_blocks,
                int rt, int n_boxes, int aabb_cols, float* out, void* stream) {
  if (n_blocks == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    toy_mask_kernel<0><<<n_blocks, rt, 0, s>>>(rays, aabb, n_boxes,
                                               aabb_cols, out);
  else if (mode == 1)
    toy_mask_kernel<1><<<n_blocks, rt, 0, s>>>(rays, aabb, n_boxes,
                                               aabb_cols, out);
  else
    toy_mask_kernel<2><<<n_blocks, rt, 0, s>>>(rays, aabb, n_boxes,
                                               aabb_cols, out);
  return (int)cudaGetLastError();
}

int rt_sel7(const int* win, const float* q, int n_rays, int lanes, int visits,
            float* out, void* stream) {
  if (n_rays == 0) return 0;
  sel7_kernel<<<(n_rays + kColThreads - 1) / kColThreads, kColThreads,
                kSelRows * lanes * sizeof(float), (cudaStream_t)stream>>>(
      win, q, n_rays, lanes, visits, out);
  return (int)cudaGetLastError();
}

int rt_mm22(const int* win, const unsigned short* qsel, int n_rays, int lanes,
            int qcols, int visits, float* out, void* stream) {
  if (n_rays == 0) return 0;
  const size_t smem = (size_t)(lanes / 16) * kMmTiles * 32 * sizeof(uint2) +
                      2 * kMmWarps * kMmRays * kMmStride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mm22_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mm22_kernel<<<n_rays / kMmRays, kMmWarps * 32, smem, (cudaStream_t)stream>>>(
      win, qsel, lanes, qcols, visits, out);
  return (int)cudaGetLastError();
}

int rt_dyn_reads(int block_major, const float* q, int lanes, int visits,
                 float* out, void* stream) {
  if (lanes == 0) return 0;
  const int grid = (lanes + kColThreads - 1) / kColThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (block_major)
    dyn_reads_kernel<true><<<grid, kColThreads, 0, s>>>(q, lanes, visits, out);
  else
    dyn_reads_kernel<false><<<grid, kColThreads, 0, s>>>(q, lanes, visits,
                                                        out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
