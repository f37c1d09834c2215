// Deterministic scatter-accumulate for Hopper (sm_90a): kernel J, the
// backward pass of the differentiable row gather (ops/diff_gather.py).
//
// Replaces the Pallas TPU kernel raytracinginonesemester_tpu/ops/
// diff_gather.py:_segment_accum_kernel (segment_accum_rows).  That kernel
// is a one-hot MXU contraction over 512-ray tiles, because the TPU has no
// scatter; the function it computes is out[b, f] = sum of ct[r, f] over
// the rays r with idx[r] == b, out-of-range ids dropped, in a fixed order.
//
// Design.  A sorted segmented reduction.  The glue (the wrapper, torch ops)
// sorts the ray ids stably, so each bin's rays form one run of `perm` in
// ascending ray order, and gives each bin its run's start and length.  One
// thread owns one (bin, feature) output and adds its run's cotangents one by
// one in ascending ray order, from 0.0f: no float atomics, the same sum on
// every run, and bit for bit the sum of the plain version (a sequential
// index_add_ on the host).  The cotangent is read feature-major, (F, R),
// like the JAX kernel's (16, R) operand.  Adjacent threads are the features
// of one bin: they share each perm load and write their outputs together.
//
// What bounds it on this card: the longest run.  A bin's sum is one serial
// chain of dependent adds, so a bin that holds most rays (row 0 collects
// every ray that missed) takes one thread through all of them; the loads of
// a batch are issued before its adds to keep several in flight.  The bytes
// the function must move (ids, cotangents, the table gradient) are a few
// microseconds of the card's memory rate.  A parallel but still fixed-order
// reduction of long runs is work for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBatch = 8;

}  // namespace

__global__ void __launch_bounds__(kThreads)
segment_accum_kernel(const float* __restrict__ ct, const int* __restrict__ perm,
                     const int* __restrict__ start,
                     const int* __restrict__ count, int n_rays, int rows,
                     int n_feat, float* __restrict__ out) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= rows * n_feat) return;
  const int b = gid / n_feat, f = gid % n_feat;
  const float* row = ct + (size_t)f * n_rays;
  const int* run = perm + start[b];
  const int n = count[b];
  float acc = 0.0f;
  int j = 0;
  for (; j + kBatch <= n; j += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) v[q] = row[run[j + q]];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) acc = acc + v[q];
  }
  for (; j < n; ++j) acc = acc + row[run[j]];
  out[gid] = acc;  // (rows, F) row-major
}

// ---- C interface (loaded with ctypes) ----

extern "C" {

int rt_segment_accum(const float* ct, const int* perm, const int* start,
                     const int* count, int n_rays, int rows, int n_feat,
                     float* out, void* stream) {
  const int n = rows * n_feat;
  if (n == 0) return 0;
  segment_accum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(ct, perm, start, count,
                                                 n_rays, rows, n_feat, out);
  return (int)cudaGetLastError();
}

const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
