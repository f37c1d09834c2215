// Deterministic scatter-accumulate for Hopper (sm_90a): kernel J, the
// backward pass of the differentiable row gather (ops/diff_gather.py).
//
// Replaces the Pallas TPU kernel raytracinginonesemester_tpu/ops/
// diff_gather.py:_segment_accum_kernel (segment_accum_rows).  That kernel
// is a one-hot MXU contraction over 512-ray tiles, because the TPU has no
// scatter; the function it computes is out[b, f] = sum of ct[r, f] over
// the rays r with idx[r] == b, out-of-range ids dropped, in a fixed order.
//
// Design.  A sorted segmented reduction in a fixed two-level order.  The
// glue (ops/diff_gather.py segment_plan) sorts the ray ids stably, so each
// bin's rays form one run of `perm` in ascending ray order, and gives
// each bin its run (`bounds`) and its chunks: the run cut into kChunk
// consecutive entries from its start (`cstart`, the first chunk of each
// bin, cstart[rows] = all chunks).  Level 1, one warp per chunk: lane l
// adds entries l, l + 32, ... of the chunk in that order from +0.0f (all
// of a row's features at once), then the fixed xor tree (16, 8, 4, 2, 1)
// joins the 32 lane sums.  Level 2, one warp per bin: lane l adds the
// bin's chunk sums l, l + 32, ... from +0.0f, and the same tree joins
// them.  The order depends only on each entry's place in its run, never
// on the launch or on timing: no float atomics, the same bits on every
// run, and the bits of the plain version (which evaluates this very
// expression tree on the host).  Starting every lane at +0.0f makes a
// missing entry (a short chunk, an idle lane) the same as a +0.0 entry,
// so ragged runs need no padding.
//
// What bounds it on this card: the bytes (ids, cotangents, the table
// gradient: microseconds of the memory rate).  Adjacent lanes read
// adjacent run entries, each a whole (F <= 16)-float row of the
// row-major cotangent, so every sector of a row is used once; the longest
// dependent chain is kChunk / 32 adds in level 1 and (chunks of the
// largest bin) / 32 in level 2, however many rays one bin collects (row 0
// of a table collects most of them).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;  // run entries per chunk (diff_gather.CHUNK)
constexpr int kWarps = 4;    // warps per CTA
constexpr int kMaxFeat = 16;
constexpr unsigned kFull = 0xffffffffu;

// The fixed tree over the 32 lanes: every lane ends with the same bits
// (a + b == b + a), lane l after step `off` holding v_l + v_(l ^ off).
__device__ __forceinline__ float tree32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

// The bin of chunk w: the last b with cstart[b] <= w (empty bins share
// their cstart with the next bin and are skipped).
__device__ __forceinline__ int bin_of(const int* cstart, int rows, int w) {
  int lo = 0, hi = rows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cstart[mid] <= w)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Joins acc[f] over the warp and writes feature f's sum from lane f.
__device__ __forceinline__ void store_trees(const float* acc, int n_feat,
                                            int lane, float* dst) {
  float mine = 0.0f;
#pragma unroll
  for (int f = 0; f < kMaxFeat; ++f) {
    if (f < n_feat) {  // warp-uniform
      const float s = tree32(acc[f]);
      if (lane == f) mine = s;
    }
  }
  if (lane < n_feat) dst[lane] = mine;
}

}  // namespace

// Level 1: one warp per chunk -> partial[(chunk, F)].
__global__ void __launch_bounds__(32 * kWarps)
chunk_sum_kernel(const float* __restrict__ ct, const int* __restrict__ perm,
                 const int* __restrict__ bounds,
                 const int* __restrict__ cstart, int rows, int n_feat,
                 float* __restrict__ partial) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= cstart[rows]) return;  // warp-uniform: past the last chunk
  const int b = bin_of(cstart, rows, w);
  const int begin = bounds[b] + (w - cstart[b]) * kChunk;
  const int n = min(kChunk, bounds[b + 1] - begin);
  float acc[kMaxFeat];
#pragma unroll
  for (int f = 0; f < kMaxFeat; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunk / 32; ++i) {
    const int q = lane + 32 * i;
    if (q < n) {
      const float* row = ct + (size_t)perm[begin + q] * n_feat;
#pragma unroll
      for (int f = 0; f < kMaxFeat; ++f)
        if (f < n_feat) acc[f] = acc[f] + row[f];
    }
  }
  store_trees(acc, n_feat, lane, partial + (size_t)w * n_feat);
}

// Level 2: one warp per bin -> out[(rows, F)]; an empty bin gets +0.0.
__global__ void __launch_bounds__(32 * kWarps)
bin_sum_kernel(const float* __restrict__ partial,
               const int* __restrict__ cstart, int rows, int n_feat,
               float* __restrict__ out) {
  const int b = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (b >= rows) return;  // warp-uniform
  const int first = cstart[b];
  const int n = cstart[b + 1] - first;
  float acc[kMaxFeat];
#pragma unroll
  for (int f = 0; f < kMaxFeat; ++f) acc[f] = 0.0f;
  for (int m = lane; m < n; m += 32) {
    const float* row = partial + (size_t)(first + m) * n_feat;
#pragma unroll
    for (int f = 0; f < kMaxFeat; ++f)
      if (f < n_feat) acc[f] = acc[f] + row[f];
  }
  store_trees(acc, n_feat, lane, out + (size_t)b * n_feat);
}

// ---- C interface (loaded with ctypes) ----

extern "C" {

// max_chunks: a bound on cstart[rows] known without reading it (the
// rays over kChunk, plus one ragged chunk per bin); partial holds
// max_chunks * n_feat floats.
int rt_segment_accum(const float* ct, const int* perm, const int* bounds,
                     const int* cstart, int rows, int n_feat, int max_chunks,
                     float* partial, float* out, void* stream) {
  if (rows == 0 || n_feat == 0) return 0;
  if (n_feat > kMaxFeat) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (max_chunks > 0) {
    chunk_sum_kernel<<<(max_chunks + kWarps - 1) / kWarps, 32 * kWarps, 0,
                       s>>>(ct, perm, bounds, cstart, rows, n_feat, partial);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  bin_sum_kernel<<<(rows + kWarps - 1) / kWarps, 32 * kWarps, 0, s>>>(
      partial, cstart, rows, n_feat, out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
