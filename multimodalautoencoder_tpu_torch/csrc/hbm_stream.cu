// The device-memory stream probe, for sm_90a.
//
// Replaces the Pallas TPU kernel tools/hbm_bench.py::_stream_kernel
// (:60-122, pallas_call :112), which streamed an HBM buffer through VMEM
// chunk buffers with async copies (read, write, or both) to measure the
// rate the training kernels' Adam-moment traffic can reach.  Three
// streams over a device buffer:
//
// - read:  sum every 32-bit word of src as a signed integer into sums[k]
//          (pass k), so the result is exact and checkable; a grid-stride
//          loop of 16-byte loads, four in flight a thread;
// - write: every 32-bit word of dst set to ``value``; a grid-stride loop
//          of 16-byte stores;
// - mixed: dst = src, one read and one write of every byte, the traffic
//          of an in-place Adam step over its moments.  This is the Pallas
//          kernel's shape on Hopper's bulk-async engine: a persistent
//          kernel, one block of one warp per ring, whose elected thread
//          walks the block's chunks through a ring of RING_STAGES
//          shared-memory stages of RING_CHUNK bytes.  It loads chunk i
//          with cp.async.bulk (global -> shared, completing on the stage's
//          mbarrier), writes it back with cp.async.bulk (shared -> global,
//          one bulk group a chunk) once the barrier completes, and refills
//          a stage only after cp.async.bulk.wait_group.read says its store
//          has read it.  So each SM issues long runs of reads and long runs
//          of writes, not a warp-level mix of the two, and no thread holds
//          the data in registers.  The last chunk may be short: bulk copies
//          need 16-byte sizes and alignment, which the wrapper enforces.
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

// 2-6 stages of 8-64 KiB copied within 4 % of each other (PERF.md)
constexpr int RING_CHUNK = 32768;   // bytes a stage
constexpr int RING_STAGES = 4;      // stages a ring
constexpr int RING_SMEM = RING_CHUNK * RING_STAGES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* smem, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* smem,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(smem)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// dst = src over ``nbytes`` (a multiple of 16); block b takes chunks b,
// b + gridDim.x, ...
__global__ void __launch_bounds__(32)
copy_ring_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                 int64_t nbytes) {
  constexpr int chunk = RING_CHUNK, stages = RING_STAGES;
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[RING_STAGES];
  if (threadIdx.x != 0) return;  // the elected thread does all the work
  const int64_t chunks = (nbytes + chunk - 1) / chunk;
  if (blockIdx.x >= chunks) return;
  const int64_t n = (chunks - 1 - blockIdx.x) / gridDim.x + 1;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(&full[s]))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  auto offset = [&](int64_t i) {
    return (blockIdx.x + i * gridDim.x) * (int64_t)chunk;
  };
  auto size = [&](int64_t off) {
    return (uint32_t)(nbytes - off < chunk ? nbytes - off : chunk);
  };
  for (int64_t i = 0; i < stages && i < n; ++i) {
    const int64_t off = offset(i);
    bulk_load(ring + i * chunk, src + off, size(off), &full[i]);
  }
  for (int64_t i = 0; i < n; ++i) {
    const int s = (int)(i % stages);
    mbar_wait(&full[s], (uint32_t)((i / stages) & 1));
    const int64_t off = offset(i);
    bulk_store(dst + off, ring + s * chunk, size(off));
    // refill the previous chunk's stage once its store has read it,
    // keeping this chunk's store in flight
    const int64_t next = i - 1 + stages;
    if (i >= 1 && next < n) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int sp = (int)((i - 1) % stages);
      const int64_t noff = offset(next);
      bulk_load(ring + sp * chunk, src + noff, size(noff), &full[sp]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

cudaError_t launch_copy_ring(const void* src, void* dst, long long n_vec,
                             int steps, int sms, long long* launches,
                             cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      copy_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      RING_SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, copy_ring_kernel, 32, RING_SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t nbytes = n_vec * 16;
  const int64_t chunks = (nbytes + RING_CHUNK - 1) / RING_CHUNK;
  const int blocks =
      (int)(chunks < (int64_t)per_sm * sms ? chunks : (int64_t)per_sm * sms);
  for (int k = 0; k < steps; ++k) {
    copy_ring_kernel<<<blocks, 32, RING_SMEM, s>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// ``steps`` passes of stream ``pattern`` (0 read, 1 write, 2 mixed) over
// ``n_vec`` 16-byte vectors on ``stream``: read sums src into sums[k] for
// pass k (sums zeroed by the caller), write fills dst with ``value``, mixed
// copies src to dst through rings of RING_STAGES stages of RING_CHUNK
// bytes.  Buffers must be 16-byte aligned.  Adds its launches to
// ``*launches``; returns the first CUDA error (0 on success).
int hbm_stream_run(int pattern, const void* src, void* dst, long long n_vec,
                   int steps, unsigned int value, unsigned long long* sums,
                   long long* launches, void* stream) {
  if (n_vec <= 0 || steps <= 0) return 0;
  if (pattern < 0 || pattern > 2 || (pattern != 1 && !src)
      || (pattern != 0 && !dst) || (pattern == 0 && !sums)
      || (reinterpret_cast<uintptr_t>(src) & 15)
      || (reinterpret_cast<uintptr_t>(dst) & 15))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pattern == 2)
    return (int)launch_copy_ring(src, dst, n_vec, steps, sms, launches, s);
  const int64_t want = (n_vec + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  for (int k = 0; k < steps; ++k) {
    if (pattern == 0)
      read_kernel<<<blocks, THREADS, 0, s>>>(
          static_cast<const uint4*>(src), n_vec, sums + k);
    else
      write_kernel<<<blocks, THREADS, 0, s>>>(static_cast<uint4*>(dst),
                                              n_vec, value);
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
