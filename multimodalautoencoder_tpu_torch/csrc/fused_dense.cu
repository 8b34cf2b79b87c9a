// fused_dense: out = act(x @ w + b) in one kernel on an sm_90a card.
//
// Replaces the Pallas TPU kernel multimodalautoencoder_tpu/ops/
// pallas_kernels.py::_kernel (driven by fused_dense / _fused_dense_impl),
// which kept a whole (block_m, K) x (K, block_n) product in VMEM.  Here a
// block owns an output tile and walks K in slices staged through shared
// memory; bias and activation are applied in the epilogue, so the
// pre-activation never goes to device memory.  Three kernels:
//
// - f32 operands with at most FFMA_MAX_ROWS rows (training and evaluation
//   batches): dense_ffma_kernel, 16 x 64 tiles of exact f32 FMAs;
// - more f32 rows (serving, M = 2000): dense_sgemm_kernel, 128 x 128 tiles
//   of exact f32 FMAs, an 8 x 8 register tile a thread.  At the serve
//   shapes (K, N in {100, 1000}) a layer does 2*M*K*N <= 4 GFLOP on <= 20
//   MB of operands and output, so it is bound by the f32 CUDA cores'
//   67 TFLOP/s.  The tensor cores would be faster, but they take f32 only
//   as TF32, and 3xTF32 ("big + small", each operand split into TF32 hi and
//   lo parts), though within 5e-6 of f64 at K = 1000, leans toward zero:
//   each wgmma instruction cuts its sum toward zero rather than rounding
//   it (PERF.md keeps the measurements);
// - bf16 operands (bf16 != 0), on mma.sync: every element is rounded to
//   bf16 (round to nearest even) as its fragment is built, and the
//   products run as mma.sync.m16n8k16 bf16 with f32 sums.  The products of
//   bf16 values are exact in f32, the policy of models/mmae.py::mxu_dot.
//
// Every f32 output is fmaf(x_k, w_k, sum) in ascending k, rounded to
// nearest; where a few tiles leave the card idle (N = 100), K is split
// across a thread-block cluster of 2, 4 or 8 blocks: each block leaves its
// partial tile in its shared memory, and after a cluster barrier each block
// sums its share of rows over the partials through distributed shared
// memory, in rank order, and runs the epilogue on them.
//
// Activations are those of pallas_kernels._ACT_FNS, ids in
// config.ACTIVATIONS order: 0 linear, 1 relu, 2 tanh, 3 softsign,
// 4 softplus = log1p(exp(-|z|)) + max(z, 0); max() keeps NaN, as
// jnp.maximum and torch.relu do.
//
// The launcher takes raw pointers and a stream and returns the CUDA error
// code of the launch; it allocates nothing and does not synchronise.
//
// The bf16 kernel stages x's slice K-major ([BM][BK + 4]) and w's as it lies in memory, N-major
// ([BK][BN + pad]) for row-major w and K-major ([BN][BK + 4]) for the w.T
// view, chosen by a template parameter from the strides, so the transpose
// is never copied.  The pads put the reads of either layout on 32 distinct
// banks.  Staging copies 16 bytes at a time when every row starts 16-byte
// aligned (VEC), else 4 bytes at a time with element strides; the wrapper
// picks the instantiation at launch, so no loop has a run-time branch.
// Ragged M, N and a partial last K slice are zero-filled by the copies.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;          // depth of one staged slice
constexpr int STAGES = 4;       // slices in flight in the bf16 ring
constexpr int THREADS = 256;    // 8 warps: 2 warpgroups
constexpr int MAX_SPLIT = 8;    // portable cluster size
constexpr int MAX_DEVICES = 64;
// f32 operands with at most this many rows take the FFMA kernel
constexpr int FFMA_MAX_ROWS = 256;
constexpr int F_BM = 16, F_BN = 64;  // its tile; its slices are BK deep
constexpr int F_THREADS = 128;

// The staged ring of a BM x BN tile, and the mma.sync warp layout of the
// bf16 kernel (2 x 4 warps).
template <bool B_KMAJOR>
struct Geometry {
  static constexpr int BM = 128, BN = 128;
  static constexpr int WM = BM / 2, WN = BN / 4;
  static constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles a warp
  // K-major rows: a stride of 36 words puts (row g, col t) on bank 4g + t.
  static constexpr int A_LD = BK + 4;
  // N-major rows: (k 2t, col g) on bank 8t + g needs a stride of 4 mod 32.
  static constexpr int B_LD = B_KMAJOR ? BK + 4 : BN + 4;
  static constexpr int A_FLOATS = BM * A_LD;
  static constexpr int B_FLOATS = B_KMAJOR ? BN * B_LD : BK * B_LD;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int RING_BYTES = STAGES * STAGE_FLOATS * 4;
  // the partial tile a split block leaves for its cluster
  static constexpr int RED_LD = BN + 8;
  static constexpr int RED_BYTES = BM * RED_LD * 4;
  static_assert(MI >= 1 && NI >= 1 && WM % 16 == 0 && WN % 8 == 0, "tile");
  static_assert(A_FLOATS % 4 == 0 && B_FLOATS % 4 == 0, "16-byte stages");
  static_assert(B_LD % 4 == 0 && RED_LD % 4 == 0, "16-byte rows");
  static_assert(RED_BYTES <= RING_BYTES, "the partial fits the ring");
};

__device__ __forceinline__ float relu_keep_nan(float z) {
  return z < 0.f ? 0.f : z;
}

// The activation is a template parameter: the epilogue is unrolled over
// a thread's 32-64 outputs, and a run-time switch in each would make its
// code long enough that fetching it costs more than the stores.
template <int ACT>
__device__ __forceinline__ float activate(float z) {
  if (ACT == 1) return relu_keep_nan(z);
  if (ACT == 2) return tanhf(z);
  if (ACT == 3) return z / (1.f + fabsf(z));
  if (ACT == 4) return log1pf(expf(-fabsf(z))) + relu_keep_nan(z);
  return z;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes past ``src_bytes`` are zeroed.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Operands {
  const float* x;
  const float* w;
  const float* b;
  float* out;
  int M, N, K;
  int64_t sxm, sxk, swk, swn;
  int act;
};

// Issue the copies of k-tile ``kt`` into one stage of the ring.  Every
// loop below has a whole number of rounds of THREADS copies.
template <class G, bool B_KMAJOR, bool VEC>
__device__ __forceinline__ void stage_tile(const Operands& p, float* As,
                                           float* Bs, int m0, int n0,
                                           int kt, int tid) {
  const int k0 = kt * BK;
  static_assert((G::BM * BK) % (4 * THREADS) == 0 &&
                (G::BN * BK) % (4 * THREADS) == 0, "whole rounds");
  if (VEC) {
    // 16-byte chunks along the contiguous axis; a chunk that runs past K
    // (or N) copies only its valid bytes and zero-fills the rest
#pragma unroll
    for (int it = 0; it < G::BM * BK / 4 / THREADS; ++it) {
      const int c = tid + it * THREADS;
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + kc;
      const bool in = gm < p.M && gk < p.K;
      const int bytes = in ? 4 * min(4, p.K - gk) : 0;
      cp_async16(As + r * G::A_LD + kc, in ? p.x + gm * p.sxm + gk : p.x,
                 bytes);
    }
#pragma unroll
    for (int it = 0; it < G::BN * BK / 4 / THREADS; ++it) {
      const int c = tid + it * THREADS;
      if (B_KMAJOR) {
        const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
        const int gn = n0 + r, gk = k0 + kc;
        const bool in = gn < p.N && gk < p.K;
        const int bytes = in ? 4 * min(4, p.K - gk) : 0;
        cp_async16(Bs + r * G::B_LD + kc, in ? p.w + gn * p.swn + gk : p.w,
                   bytes);
      } else {
        const int r = c / (G::BN / 4), nc = (c % (G::BN / 4)) * 4;
        const int gk = k0 + r, gn = n0 + nc;
        const bool in = gk < p.K && gn < p.N;
        const int bytes = in ? 4 * min(4, p.N - gn) : 0;
        cp_async16(Bs + r * G::B_LD + nc, in ? p.w + gk * p.swk + gn : p.w,
                   bytes);
      }
    }
  } else {
    // one element a copy, through both element strides; a warp walks the
    // staged layout's contiguous axis
#pragma unroll 4
    for (int it = 0; it < G::BM * BK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      const bool in = gm < p.M && gk < p.K;
      cp_async4(As + r * G::A_LD + kk,
                in ? p.x + gm * p.sxm + gk * p.sxk : p.x, in ? 4 : 0);
    }
#pragma unroll 4
    for (int it = 0; it < G::BN * BK / THREADS; ++it) {
      const int e = tid + it * THREADS;
      const int r = B_KMAJOR ? e / BK : e / G::BN;
      const int c = B_KMAJOR ? e % BK : e % G::BN;
      const int gk = k0 + (B_KMAJOR ? c : r), gn = n0 + (B_KMAJOR ? r : c);
      const bool in = gk < p.K && gn < p.N;
      cp_async4(Bs + r * G::B_LD + c,
                in ? p.w + gk * p.swk + gn * p.swn : p.w, in ? 4 : 0);
    }
  }
}

// One staged slice, operands rounded to bf16: m16n8k16.
template <class G, bool B_KMAJOR>
__device__ __forceinline__ void slice_bf16(const float* As, const float* Bs,
                                           int wm0, int wn0, int g, int t,
                                           float (*acc)[G::NI][4]) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[G::MI][4], b[G::NI][2];
#pragma unroll
    for (int i = 0; i < G::MI; ++i) {
      const float* r0 = As + (wm0 + i * 16 + g) * G::A_LD + kk + 2 * t;
      const float2 p0 = *reinterpret_cast<const float2*>(r0);
      const float2 p1 = *reinterpret_cast<const float2*>(r0 + 8 * G::A_LD);
      const float2 p2 = *reinterpret_cast<const float2*>(r0 + 8);
      const float2 p3 =
          *reinterpret_cast<const float2*>(r0 + 8 * G::A_LD + 8);
      a[i][0] = pack_bf16(p0.x, p0.y);
      a[i][1] = pack_bf16(p1.x, p1.y);
      a[i][2] = pack_bf16(p2.x, p2.y);
      a[i][3] = pack_bf16(p3.x, p3.y);
    }
#pragma unroll
    for (int j = 0; j < G::NI; ++j) {
      const int n = wn0 + j * 8 + g;
      if (B_KMAJOR) {
        const float* r0 = Bs + n * G::B_LD + kk + 2 * t;
        const float2 q0 = *reinterpret_cast<const float2*>(r0);
        const float2 q1 = *reinterpret_cast<const float2*>(r0 + 8);
        b[j][0] = pack_bf16(q0.x, q0.y);
        b[j][1] = pack_bf16(q1.x, q1.y);
      } else {
        const float* c0 = Bs + (kk + 2 * t) * G::B_LD + n;
        b[j][0] = pack_bf16(c0[0], c0[G::B_LD]);
        b[j][1] = pack_bf16(c0[8 * G::B_LD], c0[9 * G::B_LD]);
      }
    }
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < G::NI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

template <int ACT>
__device__ __forceinline__ void store_pair(const Operands& p, int row,
                                           int col, float v0, float v1,
                                           bool pairs) {
  if (row >= p.M) return;
  float* o = p.out + (int64_t)row * p.N + col;
  if (pairs && col + 1 < p.N) {
    *reinterpret_cast<float2*>(o) =
        make_float2(activate<ACT>(v0 + p.b[col]),
                    activate<ACT>(v1 + p.b[col + 1]));
    return;
  }
  if (col < p.N) o[0] = activate<ACT>(v0 + p.b[col]);
  if (col + 1 < p.N) o[1] = activate<ACT>(v1 + p.b[col + 1]);
}

// The whole accumulator tile of a block that owns its K range.
template <int ACT, class G>
__device__ __forceinline__ void store_tile(const Operands& p,
                                           float (*acc)[G::NI][4], int m0,
                                           int n0, int wm0, int wn0, int g,
                                           int t, bool pairs) {
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < G::NI; ++j) {
      const int row = m0 + wm0 + i * 16 + g;
      const int col = n0 + wn0 + j * 8 + 2 * t;
      store_pair<ACT>(p, row, col, acc[i][j][0], acc[i][j][1], pairs);
      store_pair<ACT>(p, row + 8, col, acc[i][j][2], acc[i][j][3], pairs);
    }
}

// Rows [r0, r0 + rows) of the tile, summed over the cluster's partials in
// rank order.
template <int ACT, class G>
__device__ __forceinline__ void store_reduced(const Operands& p,
                                              const float* const* parts,
                                              int split, int r0, int rows,
                                              int m0, int n0, int tid,
                                              bool pairs) {
  for (int e = tid; e < rows * (G::BN / 4); e += THREADS) {
    const int r = r0 + e / (G::BN / 4), c4 = (e % (G::BN / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < split; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(parts[q] + r * G::RED_LD + c4);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    store_pair<ACT>(p, m0 + r, n0 + c4, s.x, s.y, pairs);
    store_pair<ACT>(p, m0 + r, n0 + c4 + 2, s.z, s.w, pairs);
  }
}

// Bias, activation and store of a block's accumulators.  With split > 1
// the partial tile goes to this block's shared memory (``red``, free once
// the products are done); after the cluster barrier, rank q sums rows
// [q BM / split, (q + 1) BM / split) over all ranks' partials, in rank
// order, and writes them.
template <class G>
__device__ __forceinline__ void finish(const Operands& p,
                                       float (*acc)[G::NI][4], float* red,
                                       int split, int m0, int n0, int wm0,
                                       int wn0, int g, int t, int tid) {
  const bool pairs = (p.N & 1) == 0;  // float2 stores stay 8-byte aligned
  if (split == 1) {
    switch (p.act) {
      case 1: store_tile<1, G>(p, acc, m0, n0, wm0, wn0, g, t, pairs); break;
      case 2: store_tile<2, G>(p, acc, m0, n0, wm0, wn0, g, t, pairs); break;
      case 3: store_tile<3, G>(p, acc, m0, n0, wm0, wn0, g, t, pairs); break;
      case 4: store_tile<4, G>(p, acc, m0, n0, wm0, wn0, g, t, pairs); break;
      default: store_tile<0, G>(p, acc, m0, n0, wm0, wn0, g, t, pairs);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < G::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            red + (wm0 + i * 16 + g + 8 * h) * G::RED_LD + wn0 + j * 8 +
            2 * t) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = G::BM / split;
  const int r0 = static_cast<int>(cluster.block_rank()) * rows;
  const float* parts[MAX_SPLIT];
  for (int q = 0; q < split; ++q) parts[q] = cluster.map_shared_rank(red, q);
  switch (p.act) {
    case 1: store_reduced<1, G>(p, parts, split, r0, rows, m0, n0, tid, pairs);
      break;
    case 2: store_reduced<2, G>(p, parts, split, r0, rows, m0, n0, tid, pairs);
      break;
    case 3: store_reduced<3, G>(p, parts, split, r0, rows, m0, n0, tid, pairs);
      break;
    case 4: store_reduced<4, G>(p, parts, split, r0, rows, m0, n0, tid, pairs);
      break;
    default:
      store_reduced<0, G>(p, parts, split, r0, rows, m0, n0, tid, pairs);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// The K range of block z of ``split``: k-tiles of depth ``bk``
// [kt0, kt0 + nk).
__device__ __forceinline__ void k_range(int K, int split, int& kt0, int& nk,
                                        int bk = BK) {
  const int kt_all = (K + bk - 1) / bk;
  const int per = (kt_all + split - 1) / split;
  kt0 = blockIdx.z * per;
  nk = max(0, min(kt_all, kt0 + per) - kt0);
}

// bf16 operands on mma.sync: each of the 2 x 4 warps owns a WM x WN
// sub-tile, on 128 x 128 tiles, K split across a cluster when they leave
// most of the card idle.
template <bool B_KMAJOR, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
dense_bf16_kernel(Operands p, int split) {
  using G = Geometry<B_KMAJOR>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp % 2) * G::WM, wn0 = (warp / 2) * G::WN;
  const int m0 = blockIdx.x * G::BM, n0 = blockIdx.y * G::BN;
  int kt0, nk;
  k_range(p.K, split, kt0, nk);

  float acc[G::MI][G::NI][4];
#pragma unroll
  for (int i = 0; i < G::MI; ++i)
#pragma unroll
    for (int j = 0; j < G::NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // the ring: STAGES - 1 slices ahead of the products, one commit group a
  // slice (empty groups keep the count when the slices run out)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      stage_tile<G, B_KMAJOR, VEC>(p, smem + s * G::STAGE_FLOATS,
                                   smem + s * G::STAGE_FLOATS + G::A_FLOATS,
                                   m0, n0, kt0 + s, tid);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice i landed for all; slice i - 1 is consumed
    const int ahead = i + STAGES - 1;
    if (ahead < nk) {
      float* st = smem + (ahead % STAGES) * G::STAGE_FLOATS;
      stage_tile<G, B_KMAJOR, VEC>(p, st, st + G::A_FLOATS, m0, n0,
                                   kt0 + ahead, tid);
    }
    cp_async_commit();
    const float* st = smem + (i % STAGES) * G::STAGE_FLOATS;
    slice_bf16<G, B_KMAJOR>(st, st + G::A_FLOATS, wm0, wn0, g, t, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  finish<G>(p, acc, smem, split, m0, n0, wm0, wn0, g, t, tid);
}

// f32 operands with few rows (M <= FFMA_MAX_ROWS: a training batch, a
// phase-2 batch, an evaluation batch): exact f32 FMAs on the CUDA cores.
// Such a layer reads w once for a few rows, so it is bound by w's bytes
// (or, near 256 rows, by the CUDA cores' 67 TFLOP/s), and the tensor cores
// buy it nothing.  They would also cost it accuracy that training sees:
// each wgmma instruction cuts its sum toward zero, which shrinks every
// output a little (the error's mean along the output's sign is about 0.6
// of its root mean square at K = 1000), and that shrink lines up across a
// batch in the gradients.  Here every output is fmaf(x_k, w_k, sum) in
// ascending k, rounded to nearest, and a split K range is summed over the
// cluster in rank order.  A block owns a 16 x 64 tile; each of its 128
// threads two rows by four columns (columns 16 apart, so a warp reads
// consecutive words of w's slice).  Slices of x and w go through two
// buffers in static shared memory, the next slice loaded into registers
// while the current one is multiplied; x is stored k-major and w's rows
// are padded to 65 words, so either orientation of w stores without bank
// conflicts.
struct FfmaSmem {
  float xs[2][BK][F_BM + 1];
  float ws[2][BK][F_BN + 1];
};

template <bool B_KMAJOR>
__device__ __forceinline__ void ffma_load(const Operands& p, int m0, int n0,
                                          int k0, int tid, float (&xr)[4],
                                          float (&wr)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = tid + F_THREADS * q, m = e / BK, k = e % BK;
    xr[q] = m0 + m < p.M && k0 + k < p.K
                ? __ldg(p.x + (int64_t)(m0 + m) * p.sxm +
                        (int64_t)(k0 + k) * p.sxk)
                : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    // along w's contiguous axis: k for the w.T view, n otherwise
    const int e = tid + F_THREADS * q;
    const int k = B_KMAJOR ? e % BK : e / F_BN;
    const int n = B_KMAJOR ? e / BK : e % F_BN;
    wr[q] = k0 + k < p.K && n0 + n < p.N
                ? __ldg(p.w + (int64_t)(k0 + k) * p.swk +
                        (int64_t)(n0 + n) * p.swn)
                : 0.f;
  }
}

template <bool B_KMAJOR>
__device__ __forceinline__ void ffma_store(FfmaSmem& sm, int buf, int tid,
                                           const float (&xr)[4],
                                           const float (&wr)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = tid + F_THREADS * q;
    sm.xs[buf][e % BK][e / BK] = xr[q];
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int e = tid + F_THREADS * q;
    const int k = B_KMAJOR ? e % BK : e / F_BN;
    const int n = B_KMAJOR ? e / BK : e % F_BN;
    sm.ws[buf][k][n] = wr[q];
  }
}

template <int ACT>
__device__ __forceinline__ void ffma_store_out(const Operands& p, int row,
                                               int col, float v) {
  if (row < p.M && col < p.N)
    p.out[(int64_t)row * p.N + col] = activate<ACT>(v + p.b[col]);
}

template <int ACT>
__device__ __forceinline__ void ffma_finish(const Operands& p,
                                            const float (&acc)[2][4],
                                            FfmaSmem& sm, int split, int m0,
                                            int n0, int tid) {
  const int r = 2 * (tid / 16), c = tid % 16;
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ffma_store_out<ACT>(p, m0 + r + i, n0 + c + 16 * j, acc[i][j]);
    return;
  }
  // the partial tile in this block's (free) w buffers, summed over the
  // cluster's partials in rank order by the rank that owns its rows
  float* red = &sm.ws[0][0][0];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(r + i) * (F_BN + 1) + c + 16 * j] = acc[i][j];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = F_BM / split;
  const int r0 = static_cast<int>(cluster.block_rank()) * rows;
  const float* parts[MAX_SPLIT];
  for (int q = 0; q < split; ++q) parts[q] = cluster.map_shared_rank(red, q);
  for (int e = tid; e < rows * F_BN; e += F_THREADS) {
    const int rr = r0 + e / F_BN, cc = e % F_BN;
    float v = 0.f;
    for (int q = 0; q < split; ++q) v += parts[q][rr * (F_BN + 1) + cc];
    ffma_store_out<ACT>(p, m0 + rr, n0 + cc, v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// grid (M tiles, N tiles, split); a split > 1 launches as a cluster of
// ``split`` blocks along z, one K range each.
template <bool B_KMAJOR, int ACT>
__global__ void __launch_bounds__(F_THREADS)
dense_ffma_kernel(Operands p, int split) {
  __shared__ FfmaSmem sm;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * F_BM, n0 = blockIdx.y * F_BN;
  const int r = 2 * (tid / 16), c = tid % 16;
  int kt0, nk;
  k_range(p.K, split, kt0, nk);

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float xr[4], wr[16];
  if (nk > 0) {
    ffma_load<B_KMAJOR>(p, m0, n0, kt0 * BK, tid, xr, wr);
    ffma_store<B_KMAJOR>(sm, 0, tid, xr, wr);
  }
  __syncthreads();
  for (int i = 0; i < nk; ++i) {
    const int buf = i & 1;
    if (i + 1 < nk)
      ffma_load<B_KMAJOR>(p, m0, n0, (kt0 + i + 1) * BK, tid, xr, wr);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float a0 = sm.xs[buf][k][r], a1 = sm.xs[buf][k][r + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = sm.ws[buf][k][c + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    // the other buffer was last read before the previous barrier
    if (i + 1 < nk) ffma_store<B_KMAJOR>(sm, buf ^ 1, tid, xr, wr);
    __syncthreads();
  }
  ffma_finish<ACT>(p, acc, sm, split, m0, n0, tid);
}

// f32 operands with more rows (serving: M = 2000) take exact f32 FMAs in
// k order as well, on 128 x 128 tiles.  3xTF32 on the tensor cores is
// within 5e-6 of f64 at K = 1000, but its error leans toward zero (its
// mean along the output's sign is about -0.6 of its root mean square),
// because every wgmma instruction cuts its sum toward zero; a sum promoted
// to f32 registers after every 8-deep step still leans (about -0.14).
// Rounded to nearest, FMAs do not.
// Bound: 2*M*K*N FMA operations over the f32 CUDA cores' 67 TFLOP/s (the
// four serve layers at M = 2000: 0.131 ms), far above their bytes.  So a
// thread keeps an 8 x 8 tile of outputs in registers and reads its 8 + 8
// operands of each k as four 16-byte shared-memory loads, 64 FMAs per 4
// loads: rows {4 ty + i, 64 + 4 ty + i} and columns {4 tx + j, 64 + 4 tx
// + j} of the block's tile (16 x 16 threads).  Slices of BK_S = 8 of x
// (stored k-major) and w (n-major, whichever orientation it lies in) go
// through two buffers, the next slice loaded into registers while the
// current one is multiplied; 16-byte loads where rows are 16-byte aligned
// (VEC), else one element at a time through the strides.  Few tiles (N =
// 100) split K across a cluster, whose partials are summed in rank order
// as in the other kernels.
constexpr int BK_S = 8;            // depth of one slice
constexpr int S_LD = 128 + 4;      // a slice row: 128 rows or columns
constexpr int S_SLICE = BK_S * S_LD;
using SgemmRed = Geometry<false>;  // the split's partial tile
constexpr int SGEMM_SMEM = SgemmRed::RED_BYTES;
static_assert(4 * S_SLICE * 4 <= SGEMM_SMEM, "two slices of x and w fit");

template <bool B_KMAJOR, bool VEC>
__device__ __forceinline__ void sgemm_load(const Operands& p, int m0, int n0,
                                           int k0, int tid, float (&xr)[4],
                                           float (&wr)[4]) {
  {  // x: row tid / 2, k 4 (tid % 2) + u
    const int gm = m0 + tid / 2, gk = k0 + 4 * (tid % 2);
    const float* src = p.x + (int64_t)gm * p.sxm;
    if (VEC && gm < p.M && gk + 3 < p.K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src + gk));
      xr[0] = v.x; xr[1] = v.y; xr[2] = v.z; xr[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xr[u] = gm < p.M && gk + u < p.K
                    ? __ldg(src + (int64_t)(gk + u) * p.sxk) : 0.f;
    }
  }
  // w along its contiguous axis: k for the w.T view, n otherwise
  const int gk = B_KMAJOR ? k0 + 4 * (tid % 2) : k0 + tid / 32;
  const int gn = B_KMAJOR ? n0 + tid / 2 : n0 + 4 * (tid % 32);
  const float* src = p.w + (int64_t)gk * p.swk + (int64_t)gn * p.swn;
  const bool in = B_KMAJOR ? gn < p.N && gk + 3 < p.K
                           : gk < p.K && gn + 3 < p.N;
  if (VEC && in) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    wr[0] = v.x; wr[1] = v.y; wr[2] = v.z; wr[3] = v.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = B_KMAJOR ? gk + u : gk, n = B_KMAJOR ? gn : gn + u;
      wr[u] = k < p.K && n < p.N
                  ? __ldg(p.w + (int64_t)k * p.swk + (int64_t)n * p.swn)
                  : 0.f;
    }
  }
}

template <bool B_KMAJOR>
__device__ __forceinline__ void sgemm_store(float* xs, float* ws, int tid,
                                            const float (&xr)[4],
                                            const float (&wr)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) xs[(4 * (tid % 2) + u) * S_LD + tid / 2] = xr[u];
  if (B_KMAJOR) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      ws[(4 * (tid % 2) + u) * S_LD + tid / 2] = wr[u];
  } else {
    *reinterpret_cast<float4*>(ws + (tid / 32) * S_LD + 4 * (tid % 32)) =
        make_float4(wr[0], wr[1], wr[2], wr[3]);
  }
}

// The tile's row (or column) of a thread's i-th output row (column).
__device__ __forceinline__ int sgemm_at(int t, int i) {
  return (i < 4 ? 4 * t : 64 + 4 * t - 4) + i;
}

template <int ACT>
__device__ __forceinline__ void sgemm_store_tile(const Operands& p,
                                                 const float (&acc)[8][8],
                                                 int m0, int n0, int ty,
                                                 int tx, bool pairs) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      store_pair<ACT>(p, m0 + sgemm_at(ty, i), n0 + sgemm_at(tx, j),
                      acc[i][j], acc[i][j + 1], pairs);
}

// grid (M tiles, N tiles, split); a split > 1 launches as a cluster of
// ``split`` blocks along z, one K range each.
template <bool B_KMAJOR, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
dense_sgemm_kernel(Operands p, int split) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                // [2][BK_S][S_LD], k-major
  float* ws = smem + 2 * S_SLICE;  // [2][BK_S][S_LD], n-major
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * 128;
  int kt0, nk;
  k_range(p.K, split, kt0, nk, BK_S);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float xr[4], wr[4];
  if (nk > 0) {
    sgemm_load<B_KMAJOR, VEC>(p, m0, n0, kt0 * BK_S, tid, xr, wr);
    sgemm_store<B_KMAJOR>(xs, ws, tid, xr, wr);
  }
  __syncthreads();
  for (int s = 0; s < nk; ++s) {
    const int buf = s & 1;
    if (s + 1 < nk)
      sgemm_load<B_KMAJOR, VEC>(p, m0, n0, (kt0 + s + 1) * BK_S, tid, xr,
                                wr);
    const float* xb = xs + buf * S_SLICE;
    const float* wb = ws + buf * S_SLICE;
#pragma unroll
    for (int k = 0; k < BK_S; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(xb + k * S_LD + 4 * ty);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(xb + k * S_LD + 64 + 4 * ty);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(wb + k * S_LD + 4 * tx);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(wb + k * S_LD + 64 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read before the previous barrier
    if (s + 1 < nk)
      sgemm_store<B_KMAJOR>(xs + (buf ^ 1) * S_SLICE,
                            ws + (buf ^ 1) * S_SLICE, tid, xr, wr);
    __syncthreads();
  }
  const bool pairs = (p.N & 1) == 0;  // float2 stores stay 8-byte aligned
  if (split == 1) {
    switch (p.act) {
      case 1: sgemm_store_tile<1>(p, acc, m0, n0, ty, tx, pairs); break;
      case 2: sgemm_store_tile<2>(p, acc, m0, n0, ty, tx, pairs); break;
      case 3: sgemm_store_tile<3>(p, acc, m0, n0, ty, tx, pairs); break;
      case 4: sgemm_store_tile<4>(p, acc, m0, n0, ty, tx, pairs); break;
      default: sgemm_store_tile<0>(p, acc, m0, n0, ty, tx, pairs);
    }
    return;
  }
  // the partial tile in this block's shared memory (free after the last
  // barrier), summed over the cluster in rank order as finish() does
  float* red = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 4)
      *reinterpret_cast<float4*>(red + sgemm_at(ty, i) * SgemmRed::RED_LD +
                                 sgemm_at(tx, j)) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = SgemmRed::BM / split;
  const int r0 = static_cast<int>(cluster.block_rank()) * rows;
  const float* parts[MAX_SPLIT];
  for (int q = 0; q < split; ++q) parts[q] = cluster.map_shared_rank(red, q);
  switch (p.act) {
    case 1: store_reduced<1, SgemmRed>(p, parts, split, r0, rows, m0, n0, tid,
                                       pairs); break;
    case 2: store_reduced<2, SgemmRed>(p, parts, split, r0, rows, m0, n0, tid,
                                       pairs); break;
    case 3: store_reduced<3, SgemmRed>(p, parts, split, r0, rows, m0, n0, tid,
                                       pairs); break;
    case 4: store_reduced<4, SgemmRed>(p, parts, split, r0, rows, m0, n0, tid,
                                       pairs); break;
    default: store_reduced<0, SgemmRed>(p, parts, split, r0, rows, m0, n0,
                                        tid, pairs);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

int device_index() {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= MAX_DEVICES)
    return -1;
  return device;
}

template <auto kernel>
cudaError_t launch(int smem_bytes, int bm, int bn, const Operands& p,
                   int split, cudaStream_t stream, int threads = THREADS) {
  // the dynamic shared-memory limit is raised once per device and kernel
  static bool raised[MAX_DEVICES] = {};
  const int device = device_index();
  if (device < 0) return cudaErrorInvalidDevice;
  if (smem_bytes > 0 && !raised[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.M + bm - 1) / bm, (p.N + bn - 1) / bn, split);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool B_KMAJOR, bool VEC>
cudaError_t launch_sgemm(const Operands& p, int split, cudaStream_t s) {
  return launch<dense_sgemm_kernel<B_KMAJOR, VEC>>(SGEMM_SMEM, 128, 128, p,
                                                   split, s);
}

template <bool B_KMAJOR, bool VEC>
cudaError_t launch_bf16(const Operands& p, int split, cudaStream_t s) {
  using G = Geometry<B_KMAJOR>;
  return launch<dense_bf16_kernel<B_KMAJOR, VEC>>(G::RING_BYTES, G::BM, G::BN,
                                                  p, split, s);
}

template <bool B_KMAJOR>
cudaError_t launch_ffma(const Operands& p, int split, cudaStream_t s) {
  switch (p.act) {
    case 1: return launch<dense_ffma_kernel<B_KMAJOR, 1>>(0, F_BM, F_BN, p,
                                                         split, s, F_THREADS);
    case 2: return launch<dense_ffma_kernel<B_KMAJOR, 2>>(0, F_BM, F_BN, p,
                                                         split, s, F_THREADS);
    case 3: return launch<dense_ffma_kernel<B_KMAJOR, 3>>(0, F_BM, F_BN, p,
                                                         split, s, F_THREADS);
    case 4: return launch<dense_ffma_kernel<B_KMAJOR, 4>>(0, F_BM, F_BN, p,
                                                         split, s, F_THREADS);
    default: return launch<dense_ffma_kernel<B_KMAJOR, 0>>(
        0, F_BM, F_BN, p, split, s, F_THREADS);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int sm_count() {
  static int sms[MAX_DEVICES] = {};
  const int device = device_index();
  if (device < 0) return 132;
  if (!sms[device] &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 132;
  return sms[device];
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The largest split in 1, 2, 4, 8 that keeps ``tiles`` x split blocks
// within ``limit`` and at least two k-tiles a block.
int choose_split(long long tiles, int kt_all, long long limit) {
  int split = 1;
  while (split < MAX_SPLIT && tiles * split * 2 <= limit &&
         kt_all >= 4 * split)
    split *= 2;
  return split;
}

}  // namespace

extern "C" {

// out (M, N) row-major = act(x @ w + b); x (M, K) and w (K, N) are read
// through their element strides, b (N,) is contiguous.  Returns the
// cudaError_t of the launch (0 on success).
int fused_dense_launch(const float* x, const float* w, const float* b,
                       float* out, int M, int N, int K, long long sxm,
                       long long sxk, long long swk, long long swn, int act,
                       int bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (act < 0 || act > 4 || K < 0) return (int)cudaErrorInvalidValue;
  if (ceil_div(N, 128) > 65535) return (int)cudaErrorInvalidConfiguration;
  const Operands p{x, w, b, out, M, N, K, sxm, sxk, swk, swn, act};
  // w is staged along its contiguous axis: K-major for the w.T view
  const bool b_kmajor = swk == 1 && swn != 1;
  // 16-byte copies need every staged row to start 16-byte aligned
  const bool vec =
      sxk == 1 && sxm % 4 == 0 && aligned16(x) && aligned16(w) &&
      (b_kmajor ? swn % 4 == 0 : swn == 1 && swk % 4 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  const int kt_all = (int)ceil_div(K, BK);
  const long long tiles = ceil_div(M, 128) * ceil_div(N, 128);
  if (!bf16 && M <= FFMA_MAX_ROWS) {
    if (ceil_div(N, F_BN) > 65535) return (int)cudaErrorInvalidConfiguration;
    // 16 x 64 tiles of 128 threads, several to an SM: K split across a
    // cluster while the tiles number under two blocks a scheduler
    const int f_split = choose_split(ceil_div(M, F_BM) * ceil_div(N, F_BN),
                                     kt_all, 4LL * sms);
    return (int)(b_kmajor ? launch_ffma<true>(p, f_split, s)
                          : launch_ffma<false>(p, f_split, s));
  }
  if (!bf16) {
    // 128 x 128 tiles, two to an SM: K split across a cluster while the
    // tiles fill under half of those places
    const int s_split = choose_split(tiles, (int)ceil_div(K, BK_S), 2LL * sms);
    if (b_kmajor)
      return (int)(vec ? launch_sgemm<true, true>(p, s_split, s)
                       : launch_sgemm<true, false>(p, s_split, s));
    return (int)(vec ? launch_sgemm<false, true>(p, s_split, s)
                     : launch_sgemm<false, false>(p, s_split, s));
  }
  // 128 x 128 tiles, K split across a cluster when they leave most of the
  // card idle
  const int split = choose_split(tiles, kt_all, sms);
  if (b_kmajor)
    return (int)(vec ? launch_bf16<true, true>(p, split, s)
                     : launch_bf16<true, false>(p, split, s));
  return (int)(vec ? launch_bf16<false, true>(p, split, s)
                   : launch_bf16<false, false>(p, split, s));
}

const char* fused_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
