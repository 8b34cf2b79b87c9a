// The device-memory stream probe, for sm_90a.
//
// Replaces the Pallas TPU kernel tools/hbm_bench.py::_stream_kernel
// (:60-122, pallas_call :112), which streamed an HBM buffer through VMEM
// chunk buffers with async copies (read, write, or both) to measure the
// rate the training kernels' Adam-moment traffic can reach.  Here the
// three streams are plain vectorised kernels over a device buffer, each
// thread moving 16 bytes a load or store (uint4), four in flight, grid
// stride over all SMs:
//
// - read:  sum every 32-bit word of src as a signed integer into sums[k]
//          (pass k), so the result is exact and checkable;
// - write: every 32-bit word of dst set to ``value``;
// - mixed: dst = src, one read and one write of every byte, the traffic
//          of an in-place Adam step over its moments.
//
// What bounds it: bytes only (a handful of integer operations per 16
// bytes), so its time over the bytes moved is the rate the card reaches,
// against the datasheet's 3.35 TB/s.  ``steps`` passes run back to back
// on one stream, as the TPU probe's fori_loop did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, UNROLL = 4;

__device__ __forceinline__ long long word_sum(const uint4& v) {
  return (long long)(int)v.x + (int)v.y + (int)v.z + (int)v.w;
}

__global__ void __launch_bounds__(THREADS)
read_kernel(const uint4* __restrict__ src, int64_t n,
            unsigned long long* __restrict__ sum) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  long long acc = 0;
  for (; i + (UNROLL - 1) * stride < n; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc += word_sum(v[u]);
  }
  for (; i < n; i += stride) acc += word_sum(src[i]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  // two's complement: unsigned addition is the signed sum modulo 2^64
  if ((threadIdx.x & 31) == 0) atomicAdd(sum, (unsigned long long)acc);
}

__global__ void __launch_bounds__(THREADS)
write_kernel(uint4* __restrict__ dst, int64_t n, uint32_t value) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint4 v = make_uint4(value, value, value, value);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += stride)
    dst[i] = v;
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
            int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (; i + (UNROLL - 1) * stride < n; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n; i += stride) dst[i] = src[i];
}

}  // namespace

extern "C" {

// ``steps`` passes of stream ``pattern`` (0 read, 1 write, 2 mixed) over
// ``n_vec`` 16-byte vectors on ``stream``: read sums src into sums[k] for
// pass k (sums zeroed by the caller), write fills dst with ``value``, mixed
// copies src to dst.  Adds its launches to ``*launches``; returns the
// first CUDA error (0 on success).
int hbm_stream_run(int pattern, const void* src, void* dst, long long n_vec,
                   int steps, unsigned int value, unsigned long long* sums,
                   long long* launches, void* stream) {
  if (n_vec <= 0 || steps <= 0) return 0;
  if (pattern < 0 || pattern > 2 || (pattern != 1 && !src)
      || (pattern != 0 && !dst) || (pattern == 0 && !sums))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  const int64_t want = (n_vec + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < steps; ++k) {
    if (pattern == 0)
      read_kernel<<<blocks, THREADS, 0, s>>>(
          static_cast<const uint4*>(src), n_vec, sums + k);
    else if (pattern == 1)
      write_kernel<<<blocks, THREADS, 0, s>>>(static_cast<uint4*>(dst),
                                              n_vec, value);
    else
      copy_kernel<<<blocks, THREADS, 0, s>>>(
          static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launches;
  }
  return 0;
}

const char* hbm_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
