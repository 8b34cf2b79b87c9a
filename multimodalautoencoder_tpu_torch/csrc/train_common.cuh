// Device code shared by the training kernels of csrc/train_kernel.cu (the
// phase-1 DAE/VAE run), csrc/train_deep_kernel.cu (depth >= 3) and
// csrc/cls_train_kernel.cu (the phase-2 classification run): activations,
// rsqrt Adam, the instance-batched small-M products with their epilogues
// (gemm_batch_kernel at a batch of at most 24, gemm_tile_kernel above
// it), the grouped weight and bias update (update_group_kernel), and a
// launcher that enqueues them on one stream, counts every launch and can
// time each with CUDA events.
//
// The products run in exact f32 FMAs from rings of cp.async copies.  The
// BF16 instantiations round each product operand to bfloat16 (nearest
// even) and sum in f32: the operand policy of the JAX package's
// mmae.mxu_dot.  The weight gradient is summed in exact f32 FMAs while the
// tile's W and moments are copied in.  Operand type is a template
// parameter, so the f32 kernels carry no test for it; the bf16 ones are
// built only where the including file defines TRAIN_BF16_OPERANDS.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

#ifndef TRAIN_BF16_OPERANDS
#define TRAIN_BF16_OPERANDS 0
#endif
namespace train {

constexpr float ADAM_B1 = 0.9f, ADAM_1MB1 = 0.1f;
constexpr float ADAM_B2 = 0.999f, ADAM_1MB2 = 0.001f;

// Activation ids, config.ACTIVATIONS order.
__device__ __forceinline__ float act_fn(float z, int act) {
  switch (act) {
    case 1: return z < 0.f ? 0.f : z;
    case 2: return tanhf(z);
    case 3: return z / (1.f + fabsf(z));
    case 4: return log1pf(expf(-fabsf(z))) + (z < 0.f ? 0.f : z);
    default: return z;
  }
}

__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case 1: return z > 0.f ? 1.f : 0.f;
    case 2: { const float t = tanhf(z); return 1.f - t * t; }
    case 3: { const float s = 1.f / (1.f + fabsf(z)); return s * s; }
    case 4: return 1.f / (1.f + expf(-z));
    default: return 1.f;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float load_m(const float* p) { return *p; }
__device__ __forceinline__ float load_m(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_m(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_m(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Per-instance Adam scalars of step s (optim.adam_update's rsqrt form):
// alpha = lr_s * sqrt(bc2) / bc1, es2 = bc2 * eps^2, bias corrections at
// count s + 1, lr_s = lr0 * rate^(s / decay_steps) with smooth decay.
struct AdamStep { int step, decay; float decay_steps, decay_rate, eps2; };

// The step's terms every instance shares, computed once a launch; alpha()
// then takes an instance's lr0 through the same operations.
struct AdamScalars {
  float bc1, sq2, es2, rate;
  int decay;

  __device__ __forceinline__ explicit AdamScalars(const AdamStep& st) {
    const float cf = (float)(st.step + 1);
    bc1 = 1.f - powf(ADAM_B1, cf);
    const float bc2 = 1.f - powf(ADAM_B2, cf);
    sq2 = sqrtf(bc2);
    es2 = bc2 * st.eps2;
    decay = st.decay;
    rate = decay ? powf(st.decay_rate, (float)st.step / st.decay_steps)
                 : 1.f;
  }
  __device__ __forceinline__ float alpha(float lr0) const {
    const float lr = decay ? lr0 * rate : lr0;
    return lr * sq2 / bc1;
  }
};

// One rsqrt Adam step in registers: the moments m and v move to this
// step's values and the updated weight is returned.
__device__ __forceinline__ float adam_step(float w, float g, float& m,
                                           float& v, float alpha,
                                           float es2) {
  m = ADAM_B1 * m + ADAM_1MB1 * g;
  v = ADAM_B2 * v + ADAM_1MB2 * g * g;
  return w - (alpha * m) * rsqrtf(v + es2);
}

// Moments are stored in their type (rounded when bf16), but the weight
// takes this step's unrounded f32 m and v, as the Pallas kernels do
// (train_kernel.py:358-363).
template <typename MT>
__device__ __forceinline__ float adam_apply(float w, float g, MT* m, MT* v,
                                            float alpha, float es2) {
  float mn = load_m(m), vn = load_m(v);
  const float wn = adam_step(w, g, mn, vn, alpha, es2);
  store_m(m, mn);
  store_m(v, vn);
  return wn;
}

// ------------------------------------------------------- copy primitives
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
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

// 4 (or 16) bytes from global to shared; bytes past ``src_bytes`` are
// zeroed.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One arrival on ``bar`` once this thread's earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
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

// ------------------------------------------------------------ products
// C[n] (M x ncol) = A[n] (M x K) . B[n] (K x ncol) [+ A2[n] . B2[n]], with
// small M (the batch), then an epilogue (Epi).  B is staged as it lies,
// N-major ([k][n]) for W and K-major ([n][k]) for the W^T views, so a
// transpose is never copied.  Every output element is one f32 sum of
// exact FMAs from zero, k in order, pair 0 before pair 1 (the zero-filled
// k tail of a slice adds +0 to a sum that is never -0), so a product is
// bit for bit the one of the first CUDA-core kernels, whatever its
// block's shape; bf16 operands (BF16) are rounded as they are read and
// their exact products summed the same way.  The training gates hold
// every step to the twin within rounding: tensor-core products failed
// [8], [11] and [15] with either promotion of their sums (PERF.md), since
// a relu kink or an Adam sign flip turns a changed rounding into a
// changed update.
struct Mat { const float* p; int64_t bs, rs, cs; };   // batch/row/col strides

enum Epi { E_ACT_DROP = 0, E_BIAS, E_LOGIT_GRAD, E_MUL, E_NONE };

struct EpiArgs {
  const float* bias;   // (N, ncol)
  const float* aux;    // (N, M, ncol): x for E_LOGIT_GRAD, factor for E_MUL
  float* out0;         // (N, M, ncol)
  float* out1;         // (N, M, ncol): d * act'(z) for E_ACT_DROP
  const int* seeds; const int* act; const float* keep;
  int purpose, step;
  int bf16;            // launch the BF16 instantiation
};

struct GemmArgs {
  int M, ncol, K, K2;
  Mat A, B, A2, B2;    // A, A2 K-contiguous; B, B2 in one orientation
  int vec;             // every staged row 16-byte aligned: 16-byte copies
  int b_kmajor;        // B staged [n][k] (W^T views), else [k][n]
};

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? round_bf16(v) : v;
}

// The epilogue of one output element (row, col) with sum s.
template <int EPI>
struct Epilogue {
  const EpiArgs& e;
  int n, M, ncol, act;
  float keep, inv_keep;
  uint32_t seed;

  __device__ __forceinline__ Epilogue(const EpiArgs& e_, int n_, int M_,
                                      int ncol_)
      : e(e_), n(n_), M(M_), ncol(ncol_), act(0), keep(1.f), inv_keep(1.f),
        seed(0) {
    if (EPI == E_ACT_DROP) {
      act = e.act[n];
      keep = e.keep[n];
      inv_keep = 1.f / keep;
      seed = (uint32_t)e.seeds[n];
    }
  }

  // E_ACT_DROP's dropout draw of (row, col): whether the unit is kept.
  __device__ __forceinline__ bool kept(int row, int col) const {
    return philox::uniform(philox::bits(seed, e.purpose, e.step, row, col))
           < keep;
  }

  __device__ __forceinline__ void operator()(int row, int col,
                                             float s) const {
    if (row >= M || col >= ncol) return;
    store(row, col, s, EPI == E_ACT_DROP && kept(row, col));
  }

  // An element's outputs from its sum ``s``, its bias and aux values and
  // E_ACT_DROP's draw ``in``: out0 in v0, E_ACT_DROP's gate factor in v1.
  __device__ __forceinline__ void outputs(float s, float bias, float aux,
                                          bool in, float& v0,
                                          float& v1) const {
    if (EPI == E_ACT_DROP) {
      const float z = s + bias;
      const float d = in ? inv_keep : 0.f;
      v0 = act_fn(z, act) * d;
      v1 = d * act_grad(z, act);
    } else if (EPI == E_BIAS) {
      v0 = s + bias;
    } else if (EPI == E_LOGIT_GRAD) {
      const float z = s + bias;
      v0 = 1.f / (1.f + expf(-z)) - aux;
    } else if (EPI == E_MUL) {
      v0 = s * aux;
    } else {
      v0 = s;
    }
  }

  static constexpr bool BIAS = EPI == E_ACT_DROP || EPI == E_BIAS
                               || EPI == E_LOGIT_GRAD;
  static constexpr bool AUX = EPI == E_LOGIT_GRAD || EPI == E_MUL;

  // The element's outputs, given E_ACT_DROP's draw ``in`` (else unused).
  __device__ __forceinline__ void store(int row, int col, float s,
                                        bool in) const {
    if (row >= M || col >= ncol) return;
    const int64_t o = ((int64_t)n * M + row) * ncol + col;
    float v0, v1;
    outputs(s, BIAS ? e.bias[(int64_t)n * ncol + col] : 0.f,
            AUX ? e.aux[o] : 0.f, in, v0, v1);
    e.out0[o] = v0;
    if (EPI == E_ACT_DROP) e.out1[o] = v1;
  }

  // Four elements of a row from column ``col`` (a multiple of 4), bit c of
  // ``in4`` E_ACT_DROP's draw of col + c: 16-byte loads and stores where
  // the row holds all four and its rows are 16-byte aligned, else one at a
  // time; each element's value as store() makes it.
  __device__ __forceinline__ void store4(int row, int col, const float* s,
                                         unsigned in4) const {
    if (row >= M) return;
    if ((ncol & 3) || col + 3 >= ncol) {
#pragma unroll
      for (int c = 0; c < 4; ++c) store(row, col + c, s[c], (in4 >> c) & 1);
      return;
    }
    const int64_t o = ((int64_t)n * M + row) * ncol + col;
    const float4 b = BIAS ? *reinterpret_cast<const float4*>(
                                e.bias + (int64_t)n * ncol + col)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 x = AUX ? *reinterpret_cast<const float4*>(e.aux + o)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float v0[4], v1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      outputs(s[c], (&b.x)[c], (&x.x)[c], (in4 >> c) & 1, v0[c], v1[c]);
    *reinterpret_cast<float4*>(e.out0 + o) =
        make_float4(v0[0], v0[1], v0[2], v0[3]);
    if (EPI == E_ACT_DROP)
      *reinterpret_cast<float4*>(e.out1 + o) =
          make_float4(v1[0], v1[1], v1[2], v1[3]);
  }
};

// --------------------------------------------------------- moment tiles
// A thread's four moments of one row, f32 or bf16, loaded and stored 16
// (or 8) bytes at a time where the row holds all four.

template <typename MT> struct Moments4;
template <> struct Moments4<float> {
  using Q = float4;
  Q q[4];
  __device__ __forceinline__ void load(const float* p, int row, int nc,
                                       bool vec) {
    if (vec && nc == 4) {
      q[row] = *reinterpret_cast<const float4*>(p);
      return;
    }
    float* f = &q[row].x;
#pragma unroll
    for (int c = 0; c < 4; ++c) f[c] = c < nc ? p[c] : 0.f;
  }
  __device__ __forceinline__ float get(int row, int c) const {
    return (&q[row].x)[c];
  }
  __device__ __forceinline__ void store(float* p, int row, const float* f,
                                        int nc, bool vec) {
    if (vec && nc == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nc) p[c] = f[c];
  }
};
template <> struct Moments4<__nv_bfloat16> {
  using Q = uint2;
  Q q[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int row,
                                       int nc, bool vec) {
    if (vec && nc == 4) {
      q[row] = *reinterpret_cast<const uint2*>(p);
      return;
    }
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&q[row]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      h[c] = c < nc ? p[c] : __float2bfloat16_rn(0.f);
  }
  __device__ __forceinline__ float get(int row, int c) const {
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(&q[row])[c]);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p, int row,
                                        const float* f, int nc, bool vec) {
    if (vec && nc == 4) {
      uint2 o;
      o.x = pack_bf16(f[0], f[1]);
      o.y = pack_bf16(f[2], f[3]);
      *reinterpret_cast<uint2*>(p) = o;
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c < nc) p[c] = __float2bfloat16_rn(f[c]);
  }
};

// --------------------------------------- products at a batch of <= 24
// A thread owns B_RPT = 2 rows x 4 columns, TY = ceil(M / 2) thread rows
// cover the batch (20 rows in 10 at M = 20, none padded), and its 4
// columns are contiguous for N-major B and strided for K-major B, so both
// orientations are read 16 bytes at a time.  A block is ceil(CT TY / 32)
// math warps (CT = pw / 4 column threads) and one copy warp over one
// instance's panel of pw = 64, 32 or 16 columns, picked per launch on
// the host (ops/train_deep_kernels.panel_width); its ring of BSTAGES
// slices of BK is sized to its panel, so a narrow panel holds less shared
// memory and more blocks fit an SM.  Rows past BR go to the next row
// block (grid.y).  The copy warp fills the ring with cp.async, 16 bytes a
// copy where every staged row is 16-byte aligned (every full-width
// shape), else 4 (F = 30, the head's widths 50 and 3); each lane's copies
// arrive on the slice's full barrier as they land
// (cp.async.mbarrier.arrive), and the math warps free a slot on its
// empty barrier.  A copy past the end of K is zero-filled, rows and
// columns past M and ncol are left out (they feed only outputs that are
// not stored).
constexpr int BR = 24, BK = 32, BSTAGES = 3, BPW = 64;
constexpr int B_RPT = 2;
constexpr int B_TY = BR / B_RPT;                // thread rows at most
constexpr int BT_MAX = ((BPW / 4) * B_TY / 32 + 1) * 32;
constexpr int BA_LD = BK + 4;   // K-major rows: conflict-free LDS.128
constexpr int BA_FLOATS = BR * BA_LD;
static_assert(BA_FLOATS % 4 == 0 && (BPW / 4) * B_TY % 32 == 0, "16 B");

// Bytes of one ring slice for a panel of pw columns: A's rows of BA_LD,
// then B's K-major rows of BA_LD or N-major rows of pw.
__host__ __device__ constexpr int batch_stage_bytes(int pw) {
  return 4 * (BA_FLOATS + pw * BA_LD);
}

__device__ __forceinline__ void copy_batch_slices(const GemmArgs& g,
                                                  char* ring, uint64_t* full,
                                                  uint64_t* empty, int n,
                                                  int m0, int c0, int pw,
                                                  int nk, int lane) {
  const int nk0 = (g.K + BK - 1) / BK, stage = batch_stage_bytes(pw);
  const int rows = min(BR, g.M - m0), cols = min(pw, g.ncol - c0);
  for (int i = 0; i < nk; ++i) {
    const int s = i % BSTAGES, use = i / BSTAGES;
    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
    const int pair = i >= nk0;
    const int k0 = (pair ? i - nk0 : i) * BK;
    const int kv = min(BK, (pair ? g.K2 : g.K) - k0);
    const Mat a = pair ? g.A2 : g.A, b = pair ? g.B2 : g.B;
    const float* ap = a.p + n * a.bs + (int64_t)m0 * a.rs + k0;
    const float* bp = b.p + n * b.bs + (int64_t)k0 * b.rs
                      + (int64_t)c0 * b.cs;
    float* As = reinterpret_cast<float*>(ring + s * stage);
    float* Bs = As + BA_FLOATS;
    if (g.vec) {
      for (int e = lane; e < rows * (BK / 4); e += 32) {
        const int r = e / (BK / 4), k = (e % (BK / 4)) * 4;
        const int nb = k < kv ? 16 : 0;
        cp_async16(As + r * BA_LD + k, nb ? ap + r * a.rs + k : a.p, nb);
      }
      if (g.b_kmajor) {
        for (int e = lane; e < cols * (BK / 4); e += 32) {
          const int c = e / (BK / 4), k = (e % (BK / 4)) * 4;
          const int nb = k < kv ? 16 : 0;
          cp_async16(Bs + c * BA_LD + k, nb ? bp + c * b.cs + k : b.p, nb);
        }
      } else {
        const int cq = (cols + 3) / 4;
        for (int e = lane; e < BK * cq; e += 32) {
          const int k = e / cq, c = (e % cq) * 4;
          const int nb = k < kv ? 16 : 0;
          cp_async16(Bs + k * pw + c, nb ? bp + k * b.rs + c : b.p, nb);
        }
      }
    } else {
      for (int e = lane; e < rows * BK; e += 32) {
        const int r = e / BK, k = e % BK;
        cp_async4(As + r * BA_LD + k, k < kv ? ap + r * a.rs + k : a.p,
                  k < kv ? 4 : 0);
      }
      for (int e = lane; e < BK * cols; e += 32) {
        const int k = g.b_kmajor ? e % BK : e / cols;
        const int c = g.b_kmajor ? e / BK : e % cols;
        cp_async4(Bs + (g.b_kmajor ? c * BA_LD + k : k * pw + c),
                  k < kv ? bp + k * b.rs + c * b.cs : b.p, k < kv ? 4 : 0);
      }
    }
    cp_async_arrive(&full[s]);
  }
}

// A thread's panel column c < 4: tx + CT c for K-major B (distinct banks
// for the 16-byte column reads along k), 4 tx + c for N-major B (one
// 16-byte read a k row).
template <bool KMAJOR>
__device__ __forceinline__ int batch_col(int tx, int ct, int c) {
  return KMAJOR ? tx + ct * c : 4 * tx + c;
}

// One slice into a thread's B_RPT x 4 sums (rows 2 ty + r), k in order,
// over its first kv k rounded up to 4 (the copies zero-fill past kv).
template <bool BF16, bool KMAJOR>
__device__ __forceinline__ void batch_slice(const float* As, const float* Bs,
                                            int kv, int tx, int ty, int ct,
                                            int pw, float (&acc)[B_RPT][4]) {
#pragma unroll 2
  for (int k0 = 0; k0 < kv; k0 += 4) {
    float4 a[B_RPT];
#pragma unroll
    for (int r = 0; r < B_RPT; ++r)
      a[r] = *reinterpret_cast<const float4*>(
          As + (B_RPT * ty + r) * BA_LD + k0);
    float b[4][4];   // [k][column]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (KMAJOR) {   // j is the column
        const float4 q = *reinterpret_cast<const float4*>(
            Bs + batch_col<true>(tx, ct, j) * BA_LD + k0);
        b[0][j] = q.x; b[1][j] = q.y; b[2][j] = q.z; b[3][j] = q.w;
      } else {                  // j is the k row
        const float4 q = *reinterpret_cast<const float4*>(
            Bs + (k0 + j) * pw + 4 * tx);
        b[j][0] = q.x; b[j][1] = q.y; b[j][2] = q.z; b[j][3] = q.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < B_RPT; ++r) {
        const float av = operand<BF16>((&a[r].x)[kk]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][c] = fmaf(av, operand<BF16>(b[kk][c]), acc[r][c]);
      }
  }
}

template <bool BF16, bool KMAJOR, int EPI>
__device__ __forceinline__ void batch_math(const GemmArgs& g,
                                           const EpiArgs& e, char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int n, int m0, int c0, int pw,
                                           int ty_rows, int nk, int tid) {
  const int ct = pw / 4, lane = tid & 31, stage = batch_stage_bytes(pw);
  const bool active = tid < ct * ty_rows;   // lanes past them only wait
  const int tx = tid % ct, ty = min(tid / ct, ty_rows - 1);
  float acc[B_RPT][4];
#pragma unroll
  for (int r = 0; r < B_RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  const int nk0 = (g.K + BK - 1) / BK;
  for (int i = 0; i < nk; ++i) {
    const int s = i % BSTAGES;
    const int kv = i < nk0 ? min(BK, g.K - i * BK)
                           : min(BK, g.K2 - (i - nk0) * BK);
    mbar_wait(&full[s], (i / BSTAGES) & 1);
    const float* As = reinterpret_cast<const float*>(ring + s * stage);
    batch_slice<BF16, KMAJOR>(As, As + BA_FLOATS, kv, tx, ty, ct, pw, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (!active) return;
  const Epilogue<EPI> epi(e, n, g.M, g.ncol);
#pragma unroll
  for (int r = 0; r < B_RPT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      epi(m0 + B_RPT * ty + r, c0 + batch_col<KMAJOR>(tx, ct, c),
          acc[r][c]);
}

// grid (panels of pw columns, row blocks of BR, N); (ceil(pw / 4 ty_rows
// / 32) + 1) warps, the last the copy warp; BSTAGES batch_stage_bytes(pw)
// bytes of dynamic shared memory.
template <int EPI, bool BF16>
__global__ void __launch_bounds__(BT_MAX, 2)
gemm_batch_kernel(const GemmArgs g, const EpiArgs e, int pw, int ty_rows) {
  extern __shared__ __align__(128) char batch_ring[];
  char* ring = batch_ring;
  __shared__ uint64_t full[BSTAGES], empty[BSTAGES];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int copy_warp = blockDim.x / 32 - 1;
  const int n = blockIdx.z, m0 = blockIdx.y * BR, c0 = blockIdx.x * pw;
  const int nk = (g.K + BK - 1) / BK + (g.K2 + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < BSTAGES; ++s) {
      mbar_init(&full[s], 32);          // one arrival per copy lane
      mbar_init(&empty[s], copy_warp);  // one per math warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == copy_warp) {
    copy_batch_slices(g, ring, full, empty, n, m0, c0, pw, nk, tid & 31);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  if (g.b_kmajor)
    batch_math<BF16, true, EPI>(g, e, ring, full, empty, n, m0, c0, pw,
                                ty_rows, nk, tid);
  else
    batch_math<BF16, false, EPI>(g, e, ring, full, empty, n, m0, c0, pw,
                                 ty_rows, nk, tid);
}

// --------------------------------------- products at a batch above 24
// The products and epilogues shaped for phase 2's batch of 100, where f32
// FMAs and the shared loads that feed them bound the 1000-wide products.
// A block holds one instance's whole batch (up to TM_MAX = 104 rows; more
// go to the next row block, grid.y) against a panel of pw columns, so
// each weight element is read from device memory once a product.  A thread owns a register tile of TR = 8 rows x TC = 8
// (or 4) columns: ty_rows = ceil(M / 8) thread rows (13 at M = 100, its
// last 4 rows idle) by ct = pw / TC thread columns, panel and tile chosen
// per launch on the host (ops/cls_train_kernels.tile_panel).
//
// K walks in TK-deep slices through a ring of TSTAGES slices, every
// thread copying with cp.async and one __syncthreads a slice:
//
// - A is staged transposed, [k][m], by 4-byte copies (A rows are
//   K-contiguous), so a thread reads its 8 rows of one k as two 16-byte
//   loads; B is staged as it lies, N-major ([k][n]) for W and K-major
//   ([n][k]) for the W^T views, 16 bytes a copy where every staged row is
//   16-byte aligned, else 4, so no transpose of B is copied;
// - N-major B: a thread's columns are 4 tx .. 4 tx + 3 (and pw / 2 + 4 tx
//   .. for TC = 8), two 16-byte loads a k, so each k costs 4 shared loads
//   for 64 FMAs; the next k's operands are loaded into a second register
//   set during this k's FMAs;
// - K-major B: a thread's columns are tx + ct c (distinct rows, so
//   distinct banks), read 16 bytes (4 k) at a time per column;
// - E_ACT_DROP's dropout draws are made during the slices, a few a slice,
//   into a bit mask of the thread's outputs, so the Philox rounds overlap
//   the FMAs instead of stalling the block's end; an instance whose keep
//   probability is 1 draws nothing (u < 1 always holds, so every unit is
//   kept, as the draw would decide).
//
// Past K, the copies zero-fill, and rows and columns past M and ncol feed
// only outputs that are not stored; every sum is as the section above
// says.  A block
// is at most TT_MAX threads: 7 warps take 8 warps' registers, so two
// blocks an SM leave a thread 128.
constexpr int TR = 8, TK = 16, TSTAGES = 4;
constexpr int TM_MAX = 104, TT_MAX = 208, TPW_MAX = 128;
constexpr int TB_LD = TK + 4;   // K-major B rows: conflict-free LDS.128

// Floats of one ring slice: A^T's TK rows of rows + 4 (16-byte aligned),
// then B's TK N-major rows of pw or pw K-major rows of TB_LD.
__host__ __device__ constexpr int tile_a_ld(int ty_rows) {
  return TR * ty_rows + 4;
}
__host__ __device__ constexpr int tile_stage_floats(int ty_rows, int pw,
                                                    bool kmajor) {
  return TK * tile_a_ld(ty_rows) + (kmajor ? pw * TB_LD : TK * pw);
}

// Slice i's copies into ``As`` (A^T) and ``Bs``: pair 0's slices, then
// pair 1's.
__device__ __forceinline__ void copy_tile_slice(const GemmArgs& g, float* As,
                                                float* Bs, int n, int m0,
                                                int c0, int pw, int ty_rows,
                                                int nk0, int i, int tid,
                                                int nt) {
  const int pair = i >= nk0;
  const int k0 = (pair ? i - nk0 : i) * TK;
  const int kv = min(TK, (pair ? g.K2 : g.K) - k0);
  const Mat a = pair ? g.A2 : g.A, b = pair ? g.B2 : g.B;
  const float* ap = a.p + n * a.bs + (int64_t)m0 * a.rs + k0;
  const float* bp = b.p + n * b.bs + (int64_t)k0 * b.rs + (int64_t)c0 * b.cs;
  const int rows = TR * ty_rows, lda = tile_a_ld(ty_rows);
  const int mv = min(rows, g.M - m0), cv = min(pw, g.ncol - c0);
  // A^T: a thread copies half a row's TK k, one k a copy
  for (int e = tid; e < rows * 2; e += nt) {
    const int m = e >> 1, kh = (e & 1) * (TK / 2);
    const float* src = ap + (int64_t)m * a.rs + kh;
    float* dst = As + kh * lda + m;
#pragma unroll
    for (int k = 0; k < TK / 2; ++k) {
      const bool in = m < mv && kh + k < kv;
      cp_async4(dst + k * lda, in ? src + k : a.p, in ? 4 : 0);
    }
  }
  if (g.vec) {
    if (g.b_kmajor) {
      for (int e = tid; e < pw * (TK / 4); e += nt) {
        const int c = e / (TK / 4), k = (e % (TK / 4)) * 4;
        const int nb = c < cv && k < kv ? 16 : 0;
        cp_async16(Bs + c * TB_LD + k, nb ? bp + (int64_t)c * b.cs + k : b.p,
                   nb);
      }
    } else {
      const int cq = pw / 4;
      for (int e = tid; e < TK * cq; e += nt) {
        const int k = e / cq, c = (e - k * cq) * 4;
        const int nb = c < cv && k < kv ? 16 : 0;
        cp_async16(Bs + k * pw + c, nb ? bp + (int64_t)k * b.rs + c : b.p,
                   nb);
      }
    }
  } else {
    for (int e = tid; e < TK * pw; e += nt) {
      const int k = g.b_kmajor ? e % TK : e / pw;
      const int c = g.b_kmajor ? e / TK : e % pw;
      const bool in = c < cv && k < kv;
      cp_async4(Bs + (g.b_kmajor ? c * TB_LD + k : k * pw + c),
                in ? bp + (int64_t)k * b.rs + (int64_t)c * b.cs : b.p,
                in ? 4 : 0);
    }
  }
}

// A thread's 8 rows of k from A^T.
template <bool BF16>
__device__ __forceinline__ void tile_rows(const float* As, int lda, int k,
                                          int ty, float (&a)[TR]) {
  const float4 lo = *reinterpret_cast<const float4*>(As + k * lda + TR * ty);
  const float4 hi = *reinterpret_cast<const float4*>(As + k * lda + TR * ty
                                                     + 4);
  a[0] = operand<BF16>(lo.x); a[1] = operand<BF16>(lo.y);
  a[2] = operand<BF16>(lo.z); a[3] = operand<BF16>(lo.w);
  a[4] = operand<BF16>(hi.x); a[5] = operand<BF16>(hi.y);
  a[6] = operand<BF16>(hi.z); a[7] = operand<BF16>(hi.w);
}

// A thread's TC columns of k from N-major B: 4 tx .. (and pw / 2 + 4 tx ..).
template <bool BF16, int TC>
__device__ __forceinline__ void tile_cols_n(const float* Bs, int pw, int k,
                                            int tx, float (&b)[TC]) {
#pragma unroll
  for (int h = 0; h < TC / 4; ++h) {
    const float4 q = *reinterpret_cast<const float4*>(
        Bs + k * pw + h * (pw / 2) + 4 * tx);
    b[4 * h] = operand<BF16>(q.x); b[4 * h + 1] = operand<BF16>(q.y);
    b[4 * h + 2] = operand<BF16>(q.z); b[4 * h + 3] = operand<BF16>(q.w);
  }
}

template <int TC>
__device__ __forceinline__ void tile_fma(const float (&a)[TR],
                                         const float (&b)[TC],
                                         float (&acc)[TR][TC]) {
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
}

// One slice into a thread's TR x TC sums, k in order.
template <bool BF16, int TC>
__device__ __forceinline__ void tile_slice_n(const float* As, const float* Bs,
                                             int lda, int pw, int tx, int ty,
                                             float (&acc)[TR][TC]) {
  float a[2][TR], b[2][TC];
  tile_rows<BF16>(As, lda, 0, ty, a[0]);
  tile_cols_n<BF16, TC>(Bs, pw, 0, tx, b[0]);
#pragma unroll
  for (int k = 0; k < TK; ++k) {
    if (k + 1 < TK) {   // the next k's operands, during this k's FMAs
      tile_rows<BF16>(As, lda, k + 1, ty, a[(k + 1) & 1]);
      tile_cols_n<BF16, TC>(Bs, pw, k + 1, tx, b[(k + 1) & 1]);
    }
    tile_fma<TC>(a[k & 1], b[k & 1], acc);
  }
}

// K-major B: a thread's TC columns of 4 k at a time (one 16-byte load a
// column), the rows of each k loaded during the previous k's FMAs.
template <bool BF16, int TC>
__device__ __forceinline__ void tile_slice_k(const float* As, const float* Bs,
                                             int lda, int ct, int tx, int ty,
                                             float (&acc)[TR][TC]) {
#pragma unroll
  for (int k0 = 0; k0 < TK; k0 += 4) {
    float bq[TC][4];   // [column][k]
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          Bs + (tx + ct * c) * TB_LD + k0);
      bq[c][0] = operand<BF16>(v.x); bq[c][1] = operand<BF16>(v.y);
      bq[c][2] = operand<BF16>(v.z); bq[c][3] = operand<BF16>(v.w);
    }
    float a[2][TR];
    tile_rows<BF16>(As, lda, k0, ty, a[0]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk + 1 < 4) tile_rows<BF16>(As, lda, k0 + kk + 1, ty,
                                      a[(kk + 1) & 1]);
      float b[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) b[c] = bq[c][kk];
      tile_fma<TC>(a[kk & 1], b, acc);
    }
  }
}

// grid (panels of pw columns, row blocks of TM_MAX, N); ty_rows x pw / TC
// threads; TSTAGES tile_stage_floats(ty_rows, pw, kmajor) floats of
// dynamic shared memory.
template <int EPI, bool BF16, int TC>
__global__ void __launch_bounds__(TT_MAX, 2)
gemm_tile_kernel(const GemmArgs g, const EpiArgs e, int pw, int ty_rows) {
  extern __shared__ __align__(128) float tile_ring[];
  const int tid = threadIdx.x, nt = blockDim.x, ct = pw / TC;
  const int tx = tid % ct, ty = tid / ct;
  const int n = blockIdx.z, m0 = blockIdx.y * TM_MAX, c0 = blockIdx.x * pw;
  const int nk0 = (g.K + TK - 1) / TK;
  const int nk = nk0 + (g.K2 + TK - 1) / TK;
  const int lda = tile_a_ld(ty_rows);
  const int stage = tile_stage_floats(ty_rows, pw, g.b_kmajor);
  const int a_floats = TK * lda;
  const Epilogue<EPI> epi(e, n, g.M, g.ncol);
  // E_ACT_DROP's dropout draws: bit r TC + c set where the unit is kept,
  // a few each slice
  constexpr int OUTS = TR * TC;
  const bool draw = EPI == E_ACT_DROP && epi.keep < 1.f;
  const int per = (OUTS + nk - 1) / nk;
  uint64_t kept = 0ull;
  auto col_of = [&](int c) {   // the panel column of the thread's c-th
    return g.b_kmajor ? tx + ct * c : (c / 4) * (pw / 2) + 4 * tx + c % 4;
  };
  auto issue = [&](int i) {
    float* As = tile_ring + (i % TSTAGES) * stage;
    copy_tile_slice(g, As, As + a_floats, n, m0, c0, pw, ty_rows, nk0, i,
                    tid, nt);
  };
  float acc[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0.f;
  for (int i = 0; i < TSTAGES - 1; ++i) {   // the ring's first slices
    if (i < nk) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<TSTAGES - 2>();   // slice i has landed (this thread's
    __syncthreads();   // copies), everyone's; slice i - 1 is read by all
    if (i + TSTAGES - 1 < nk) issue(i + TSTAGES - 1);
    cp_async_commit();
    for (int j = 0; draw && j < per; ++j) {
      const int q = i * per + j;
      const int row = m0 + TR * ty + q / TC, col = c0 + col_of(q % TC);
      if (q < OUTS && row < g.M && col < g.ncol && epi.kept(row, col))
        kept |= 1ull << q;
    }
    const float* As = tile_ring + (i % TSTAGES) * stage;
    if (g.b_kmajor)
      tile_slice_k<BF16, TC>(As, As + a_floats, lda, ct, tx, ty, acc);
    else
      tile_slice_n<BF16, TC>(As, As + a_floats, lda, pw, tx, ty, acc);
  }
  if (!draw) kept = ~0ull;
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = m0 + TR * ty + r;
    if (g.b_kmajor) {
#pragma unroll
      for (int c = 0; c < TC; ++c)
        epi.store(row, c0 + col_of(c), acc[r][c], (kept >> (r * TC + c)) & 1);
    } else {   // a thread's columns in runs of 4
#pragma unroll
      for (int h = 0; h < TC / 4; ++h)
        epi.store4(row, c0 + col_of(4 * h), &acc[r][4 * h],
                   (unsigned)(kept >> (r * TC + 4 * h)) & 15u);
    }
  }
}

// ------------------------------------------ one grouped update a step
// Every weight gradient + L2 + Adam and every bias gradient + Adam of a
// step in one persistent launch over a work list of items (slot,
// instance, row 0, column 0), built once a run on the host
// (ops/train_deep_kernels.update_plan): the weight tiles of the largest
// tensors first, then the bias items of 256 columns.  An update thread
// owns 4 x 4 elements of a tile of TR x TC = 4 ty x 4 tx.
//
// The update reads and writes every weight in f32 and both moments (16 B
// a parameter with bf16 moments) and sums 2 B FLOP an element over the
// batch.  The plan picks one of two paths for a launch, from the batch
// and what shared memory holds (``depth``, 0 for the in-place path):
//
// - The ring path (B <= WBK: phase 1's 20).  Below the card's ridge, the
//   W, m and v bytes have to stream: a tile spans whole rows (ty =
//   WTHREADS / tx, tx = C / 4 up to 512 columns) or, for a wider tensor,
//   a strip of them (504 of 1000), so an item's W, m and v are one
//   contiguous run each (or one a row).  A copy warp moves them between
//   global and shared memory by bulk copies (cp.async.bulk, spread over
//   its lanes) through a ring of ``depth`` stages on mbarriers, ``depth``
//   - 1 items ahead; the update threads take L2 + Adam in the stage, and
//   the copy warp writes it back by bulk copies while the next items are
//   summed.  On an H100, 4-row bulk items alone streamed W, m and v at
//   2.82 TB/s against 1.7-2.2 TB/s for 64 x 64 tiles read into registers
//   (PERF.md, section 6).  A block takes a contiguous share of the list,
//   walking down strips, so a strip's gradient columns (pairs x B x TC
//   floats) are staged once a strip, by bulk copies, into one of
//   ``r_bufs`` buffers (two where they leave three stages, so the next
//   strip's wait only for the sums of the strip two back), and each item
//   stages only its TR layer-input rows by the copy warp's cp.async.
//   Three stages or more kept the ring as fast as six, two lost a third
//   (PERF.md, section 6).  A tensor the bulk copies cannot take (columns not
//   a multiple of 4, a row or copy off 16 bytes, a pointer misaligned:
//   the F = 30 widths, the heads' 50 and 3 columns) reads and writes its
//   W, m and v in place at its L2 + Adam.
// - The in-place path (B > WBK: phase 2's 100; or where two stages do
//   not fit beside the gradients).  Its sums are 100 FMAs
//   an element, near the ridge: 64 x 64 tiles, an item's own W, m, v
//   read into registers at its start, in flight during the sums, and the
//   batch staged by every thread in two chunks of half of it (at most
//   UPD_DEEP_ROWS rows), since fewer, longer chunks hid the staging
//   better than 16- to 32-row ones.  The ring's hand-offs cost more than
//   they hid there (PERF.md, section 6).
//
// Both read each work-list entry one item ahead of its use (an entry read
// where it is used stalled the in-order warps) and the tensors'
// descriptors from shared memory, and take Adam's step terms once a
// launch.  Every gradient element is summed over b in order, the tied
// weight's encode pair before its decode pair, then rsqrt Adam on acc +
// l2 * w (adam_step), and every bias element over b in order from zero:
// each bit for bit the first, separate weight- and bias-update kernels'.
// With bf16 operands (BF16, phase 2's compute_dtype) the layer inputs and
// gradients are rounded as they are read.
constexpr int WTHREADS = 256;              // update threads a block
constexpr int UPD_BLOCK = WTHREADS + 32;   // and the ring path's copy warp
constexpr int WBK = 32;            // the ring path's batch at most
constexpr int UPD_LD = 160;        // an in-place staged row: TR + TC floats
constexpr int UPD_DEPTH_MAX = 6;   // stages of the ring at most
constexpr int UPD_DEEP_ROWS = 64;  // an in-place chunk's batch rows at most
constexpr int UPD_SLOTS = 66;  // descriptors (train_deep_kernel.cu NSLOT)

// An in-place chunk's batch rows: half the batch (so B = 100 takes two
// chunks of 50), at most UPD_DEEP_ROWS.
__host__ __device__ constexpr int upd_deep_rows(int B) {
  return (B + 1) / 2 < UPD_DEEP_ROWS ? (B + 1) / 2 : UPD_DEEP_ROWS;
}

// Dynamic shared memory of a ring launch: ``r_bufs`` buffers of a
// strip's gradients, then ``depth`` stages of W, m, v and layer inputs.
__host__ __device__ constexpr int upd_smem_bytes(int depth, int l_floats,
                                                 int r_floats, int r_bufs,
                                                 int stage_bytes) {
  return 4 * r_floats * r_bufs + depth * (stage_bytes + 4 * l_floats);
}

struct UpdTensor {
  int R, C, tx;        // rows (0 for a bias), columns, tile threads across
  int ring;            // W, m and v by bulk copies, else read in place
  float pen;           // the L2 factor: 2 for a tied weight, else 1
  const float* L; const float* Rm;   // the product pair (a bias: Rm = G)
  const float* L2; const float* R2;  // the second pair, or null
  float* W; void* m; void* v;        // parameters and moments, (N, R, C)
};
static_assert(sizeof(UpdTensor) <= 128, "ops/train_deep_kernels.DESC_BYTES");

struct UpdArgs {
  const UpdTensor* T;  // by parameter slot, UPD_SLOTS of them
  const int4* items;   // (slot, instance, row 0, column 0)
  int n_items, n_weight, B;
  int depth;           // the ring's stages (0: the in-place path)
  int l_floats;        // a stage's layer inputs: pairs x B x the tallest TR
  int r_floats;        // a strip's gradients: pairs x B x the widest TC
  int r_bufs;          // buffers of them: 2 stages the next strip early
  int stage_bytes;     // a stage's W, m, v: the largest ring tile's
  const float* lr; const float* wpen;
  AdamStep st;
};

// A ring tile's row stride in a stage: the tensor's columns where one
// tile spans its rows, else the strip's 4 tx.
__host__ __device__ inline int upd_ring_ld(int C, int tx) {
  return 4 * tx < C ? 4 * tx : C;
}

// Whether a ring launch's buffers hold every weight tensor's tile
// (``batch`` rows, up to two pairs) and whether every tensor marked for
// the bulk copies lies as they need it: columns a multiple of 4, W, m and
// v on 16 bytes, and each copy's offset and bytes multiples of 16 (rows
// of C x moment bytes on 16 bytes, or whole-row tiles of an even row
// count over an even number of rows).
static bool upd_ring_fits(const UpdTensor* T, int n, int batch, int depth,
                          int l_floats, int r_floats, int r_bufs,
                          int stage_bytes, int mbytes) {
  if (depth == 0) return true;
  if (batch > WBK || depth < 2 || depth > UPD_DEPTH_MAX || l_floats % 4
      || r_floats % 4 || r_bufs < 1 || r_bufs > 2 || stage_bytes % 16)
    return false;
  for (int s = 0; s < n; ++s) {
    const UpdTensor& t = T[s];
    if (t.R <= 0) continue;   // a bias
    if (t.tx < 1 || t.tx > WTHREADS) return false;
    const int TR = 4 * (WTHREADS / t.tx), TC = 4 * t.tx;
    const int pairs = t.L2 ? 2 : 1;
    if (pairs * batch * TR > l_floats || pairs * batch * TC > r_floats)
      return false;
    if (!t.ring) continue;
    const int ld = upd_ring_ld(t.C, t.tx);
    if (t.C % 4 || TR * ld * (4 + 2 * mbytes) > stage_bytes
        || (reinterpret_cast<uintptr_t>(t.W) & 15)
        || (reinterpret_cast<uintptr_t>(t.m) & 15)
        || (reinterpret_cast<uintptr_t>(t.v) & 15))
      return false;
    const bool rows16 = t.C * mbytes % 16 == 0;
    if (TC < t.C ? !rows16 || TC * mbytes % 16 : !rows16 && t.R % 2)
      return false;
  }
  return true;
}

// Where a weight item's tile lies and which of its elements this thread
// owns (the in-place path's tiles: thread rows rounded down to even).
struct UpdTile {
  int slot, n, r0, c0, TR, TC, row0, col0, nc;
  bool active;

  __device__ __forceinline__ UpdTile(const UpdTensor* T, int4 it, int tid) {
    slot = it.x; n = it.y; r0 = it.z; c0 = it.w;
    const int tx = T[slot].tx, ty = (WTHREADS / tx) & ~1;
    TR = 4 * ty; TC = 4 * tx;
    active = tid < tx * ty;
    row0 = r0 + 4 * (tid / tx);
    col0 = c0 + 4 * (tid % tx);
    nc = active ? max(0, min(4, T[slot].C - col0)) : 0;
  }
};

// A ring item's tile: TR x TC (ty = WTHREADS / tx), of which the item
// spans tr x tc (the last row band or strip may be short), ``ld``
// elements a stage row; this thread's first row and column in it.
struct RingTile {
  int slot, n, r0, c0, TR, TC, tr, tc, ld, ly, rx;
  bool active;

  __device__ __forceinline__ RingTile(const UpdTensor* T, int4 it,
                                      int tid) {
    slot = it.x; n = it.y; r0 = it.z; c0 = it.w;
    const UpdTensor& t = T[slot];
    const int tx = t.tx, ty = WTHREADS / tx;
    TR = 4 * ty; TC = 4 * tx;
    tr = min(TR, t.R - r0);
    tc = min(TC, t.C - c0);
    ld = upd_ring_ld(t.C, tx);
    ly = 4 * (tid / tx);
    rx = 4 * (tid % tx);
    active = tid < tx * ty;
  }
};

// A thread's 4 x 4 of W, m and v (the in-place path).
template <typename MT>
struct WmvTile {
  float4 w[4];
  Moments4<MT> m, v;

  __device__ __forceinline__ void load(const UpdTensor& t,
                                       const UpdTile& tl) {
    const MT* mp = static_cast<const MT*>(t.m);
    const MT* vp = static_cast<const MT*>(t.v);
    const bool vec = t.C % 4 == 0 && aligned16(t.W) && aligned16(t.m)
                     && aligned16(t.v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t o = ((int64_t)tl.n * t.R + tl.row0 + i) * t.C + tl.col0;
      if (tl.row0 + i < t.R && tl.nc > 0) {
        if (vec && tl.nc == 4) {
          w[i] = *reinterpret_cast<const float4*>(t.W + o);
        } else {
          float* f = &w[i].x;
#pragma unroll
          for (int c = 0; c < 4; ++c) f[c] = c < tl.nc ? t.W[o + c] : 0.f;
        }
        m.load(mp + o, i, tl.nc, vec);
        v.load(vp + o, i, tl.nc, vec);
      }
    }
  }
};

// A row's four moments as floats (16 bytes f32, 8 bf16), and back.
__device__ __forceinline__ void moments_in(const char* p, const float*,
                                           float (&f)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
}
__device__ __forceinline__ void moments_in(const char* p,
                                           const __nv_bfloat16*,
                                           float (&f)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int c = 0; c < 4; ++c) f[c] = __bfloat162float(h[c]);
}
__device__ __forceinline__ void moments_out(char* p, const float*,
                                            const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void moments_out(char* p, const __nv_bfloat16*,
                                            const float (&f)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// A row's first nc <= 4 values of W or a moment in place, as floats (16
// or 8 bytes at once where ``vec`` and the row holds four), and back.
template <typename T>
__device__ __forceinline__ void load_row(const T* p, float (&f)[4], int nc,
                                         bool vec) {
  if (vec && nc == 4) {
    moments_in(reinterpret_cast<const char*>(p), p, f);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) f[c] = c < nc ? load_m(p + c) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, const float (&f)[4], int nc,
                                          bool vec) {
  if (vec && nc == 4) {
    moments_out(reinterpret_cast<char*>(p), p, f);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < nc) store_m(p + c, f[c]);
}

// One weight item's sums over ``nb`` batch rows: this thread's 4 layer
// inputs at ``l + ly`` and 4 gradients at ``r + rx``, ``lld`` and ``rld``
// floats a row, b in order.
template <bool BF16>
__device__ __forceinline__ void upd_sums(const float* l, int lld,
                                         const float* r, int rld, int nb,
                                         int ly, int rx,
                                         float (&acc)[4][4]) {
#pragma unroll 4
  for (int b = 0; b < nb; ++b) {
    const float4 l4 = *reinterpret_cast<const float4*>(l + b * lld + ly);
    const float4 r4 = *reinterpret_cast<const float4*>(r + b * rld + rx);
    const float lv[4] = {operand<BF16>(l4.x), operand<BF16>(l4.y),
                         operand<BF16>(l4.z), operand<BF16>(l4.w)};
    const float rv[4] = {operand<BF16>(r4.x), operand<BF16>(r4.y),
                         operand<BF16>(r4.z), operand<BF16>(r4.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(lv[i], rv[c], acc[i][c]);
  }
}

// A weight item's L2 + Adam from this thread's sums and its W, m, v in
// registers, and W, m, v back (the in-place path).
template <typename MT>
__device__ __forceinline__ void upd_adam(const UpdTensor& t,
                                         const UpdTile& tl,
                                         WmvTile<MT>& cur,
                                         const float (&acc)[4][4],
                                         float alpha, float es2, float l2) {
  const bool vw = t.C % 4 == 0 && aligned16(t.W) && aligned16(t.m)
                  && aligned16(t.v);
  MT* mp = static_cast<MT*>(t.m);
  MT* vp = static_cast<MT*>(t.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tl.row0 + i >= t.R || tl.nc == 0) continue;
    const int64_t o = ((int64_t)tl.n * t.R + tl.row0 + i) * t.C + tl.col0;
    float wn[4], mn[4], vn[4];
    const float* wf = &cur.w[i].x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mn[c] = cur.m.get(i, c);
      vn[c] = cur.v.get(i, c);
      wn[c] = adam_step(wf[c], acc[i][c] + l2 * wf[c], mn[c], vn[c], alpha,
                        es2);
    }
    if (vw && tl.nc == 4) {
      *reinterpret_cast<float4*>(t.W + o) =
          make_float4(wn[0], wn[1], wn[2], wn[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < tl.nc) t.W[o + c] = wn[c];
    }
    cur.m.store(mp + o, i, mn, tl.nc, vw);
    cur.v.store(vp + o, i, vn, tl.nc, vw);
  }
}

// Bias items: 256 columns of one instance's bias, a column a thread, each
// summed over b in order from zero.
template <typename MT>
__device__ __forceinline__ void upd_biases(const UpdArgs& u,
                                           const UpdTensor* T,
                                           const AdamScalars& adam) {
  const int tid = threadIdx.x, B = u.B;
  for (int it = u.n_weight + blockIdx.x; it < u.n_items; it += gridDim.x) {
    const int4 w = u.items[it];
    const UpdTensor& t = T[w.x];
    const int n = w.y, col = w.w + tid;
    if (col >= t.C) continue;
    const float* g = t.Rm + (int64_t)n * B * t.C + col;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += g[(int64_t)b * t.C];
    const int64_t o = (int64_t)n * t.C + col;
    t.W[o] = adam_apply(t.W[o], s, static_cast<MT*>(t.m) + o,
                        static_cast<MT*>(t.v) + o, adam.alpha(u.lr[n]),
                        adam.es2);
  }
}

// ------------------------------------------------ bulk copies (the ring)
__device__ __forceinline__ void bulk_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// ``bytes`` (a multiple of 16, both ends on 16 bytes) into shared memory,
// completing on ``bar``; or back to global memory in the open bulk group.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* gmem, const void* smem,
                                          uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gmem),
      "r"(smem_addr(smem)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk groups but the newest have read their shared memory.
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Item ``tl``'s W, m and v between global memory and stage ``st`` (W,
// then m at TR ld 4 bytes, then v): one copy each for a whole-row tile,
// else one a row, spread over the copy warp's lanes.  Loads complete on
// ``bar``, whose expectation lane 0 has set.
template <typename MT, bool STORE>
__device__ __forceinline__ void ring_wmv(const UpdTensor& t,
                                         const RingTile& tl, char* st,
                                         uint64_t* bar, int lane) {
  constexpr int mb = sizeof(MT);
  const bool whole = tl.ld == t.C;   // one tile spans the rows: c0 = 0
  const int rows = whole ? 1 : tl.tr;
  const int64_t len = whole ? (int64_t)tl.tr * t.C : tl.tc;
  for (int q = lane; q < 3 * rows; q += 32) {
    const int i = q / 3, a = q - 3 * i;   // row, then W, m or v
    const int64_t o = ((int64_t)tl.n * t.R + tl.r0 + i) * t.C + tl.c0;
    const int eb = a ? mb : 4;
    char* const sp = st + (a ? tl.TR * tl.ld * (4 + (a - 1) * mb) : 0)
                     + eb * i * tl.ld;
    char* const gp = static_cast<char*>(a == 0 ? static_cast<void*>(t.W)
                                        : a == 1 ? t.m : t.v) + eb * o;
    if constexpr (STORE)
      bulk_copy(gp, sp, (uint32_t)(eb * len));
    else
      bulk_copy(sp, gp, (uint32_t)(eb * len), bar);
  }
}

// The copy warp's cp.async of ``width`` columns from ``start`` (zero past
// ``limit``) of each of the B batch rows (``ld`` floats apart) of one or
// two pairs' instance ``n`` into ``dst``: pair, then batch row, ``width``
// floats a row.  One arrival on ``bar`` once they land.
__device__ __forceinline__ void ring_rows(const float* p0, const float* p1,
                                          int64_t ld, int n, int B,
                                          int start, int width, int limit,
                                          bool vec, float* dst, int lane,
                                          uint64_t* bar) {
  const int step = vec ? 4 : 1, per = width / step;
  const int rows = (p1 ? 2 : 1) * B;   // pair-major batch rows
  // lane's first piece and row, then 32 pieces on: a row and a piece on
  const int dr = 32 / per, dj = (32 - dr * per) * step;
  int r = lane / per, j = (lane - r * per) * step;
  for (; r < rows; r += dr, j += dj) {
    if (j >= width) { j -= width; ++r; if (r >= rows) break; }
    const int p = r >= B, b = r - p * B;
    const float* base = (p ? p1 : p0) + ((int64_t)n * B + b) * ld + start;
    const bool in = start + j < limit;
    if (vec)
      cp_async16(dst + r * width + j, in ? base + j : p0, in ? 16 : 0);
    else
      cp_async4(dst + r * width + j, in ? base + j : p0, in ? 4 : 0);
  }
  cp_async_arrive(bar);
}

// The copy warp's gradients of the strip of item ``tl`` (its TC columns
// of each pair's B rows) into ``dst``, completing on ``bar``: a bulk copy
// a batch row where the rows lie on 16 bytes (columns past C left as they
// are: only threads that store nothing read them), else 4-byte cp.async
// zero-filled past C.
__device__ __forceinline__ void ring_grads(const UpdTensor& t,
                                           const RingTile& tl, int B,
                                           float* dst, uint64_t* bar,
                                           int lane) {
  if (t.C % 4 == 0 && aligned16(t.Rm) && (!t.R2 || aligned16(t.R2))) {
    const int rows = (t.R2 ? 2 : 1) * B;
    if (lane == 0) bulk_expect(bar, (uint32_t)(rows * tl.tc * 4));
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {
      const int p = r >= B;
      bulk_copy(dst + r * tl.TC,
                (p ? t.R2 : t.Rm) + ((int64_t)tl.n * B + r - p * B) * t.C
                    + tl.c0,
                (uint32_t)(tl.tc * 4), bar);
    }
    cp_async_arrive(bar);
  } else {
    if (lane == 0) mbar_arrive(bar);
    ring_rows(t.Rm, t.R2, t.C, tl.n, B, tl.c0, tl.TC, t.C, false, dst, lane,
              bar);
  }
}

// The ring path (B <= WBK): WTHREADS update threads and the copy warp,
// upd_smem_bytes(u.depth, u.l_floats, u.r_floats, u.r_bufs,
// u.stage_bytes) bytes of dynamic shared memory.
template <typename MT, bool BF16>
__device__ __forceinline__ void update_ring(const UpdArgs& u,
                                            const UpdTensor* T,
                                            const AdamScalars& adam) {
  __shared__ uint64_t full[UPD_DEPTH_MAX], done[UPD_DEPTH_MAX];
  __shared__ int4 staged[UPD_DEPTH_MAX];   // the copy warp's items in stages
  __shared__ uint64_t r_full[2], r_free[2];
  extern __shared__ __align__(128) char upd_smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int S = u.depth, B = u.B;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);   // the bulk expectation + a lane's cp.async
      mbar_init(&done[s], WTHREADS / 32);   // an update warp's
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&r_full[b], 33);   // lane 0's, and a lane's cp.async
      mbar_init(&r_free[b], WTHREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // strip q's gradients in buffer q % r_bufs, its use q / r_bufs
  float* const rbuf = reinterpret_cast<float*>(upd_smem);
  const int nb = u.r_bufs;
  char* const ring = upd_smem + 4 * u.r_floats * nb;
  const int sbytes = u.stage_bytes + 4 * u.l_floats;
  // this block's share of the weight items, contiguous, so that it walks
  // down a strip; slot -1 past its last
  const int G = gridDim.x;
  const int lo = (int)((long long)blockIdx.x * u.n_weight / G);
  const int cnt = (int)((long long)(blockIdx.x + 1) * u.n_weight / G) - lo;
  auto entry = [&](int k) {
    return k < cnt ? u.items[lo + k] : make_int4(-1, 0, 0, 0);
  };
  auto same_strip = [](int4 a, int4 b) {
    return a.x == b.x && a.y == b.y && a.w == b.w;
  };

  if (tid >= WTHREADS) {   // the copy warp
    int strips = 0;   // strips staged
    int4 prev = make_int4(-1, 0, 0, 0), e = entry(0);
    for (int j = 0; j < cnt + S - 1; ++j) {
      const int4 next = entry(j + 1);   // in flight during this pass
      // item j - S + 1's stage back, once its L2 + Adam is done
      const int js = j - (S - 1);
      if (js >= 0) {
        mbar_wait(&done[js % S], (js / S) & 1);
        const int4 es = staged[js % S];
        if (T[es.x].ring)
          ring_wmv<MT, true>(T[es.x], RingTile(T, es, 0),
                             ring + (js % S) * sbytes, nullptr, lane);
        bulk_commit();   // a group a pass, empty or not
      }
      if (j < cnt) {
        // item j into stage j % S, once item j - S's stores have read it
        const int s = j % S;
        char* const st = ring + s * sbytes;
        const RingTile tl(T, e, 0);
        const UpdTensor& t = T[tl.slot];
        if (j >= S) bulk_wait_read1();
        __syncwarp();
        if (lane == 0) {
          staged[s] = e;
          if (t.ring)
            bulk_expect(&full[s], (uint32_t)(tl.tr * tl.tc
                                             * (4 + 2 * (int)sizeof(MT))));
          else
            mbar_arrive(&full[s]);
        }
        __syncwarp();
        if (t.ring) ring_wmv<MT, false>(t, tl, st, &full[s], lane);
        const bool lvec = t.R % 4 == 0 && aligned16(t.L)
                          && (!t.L2 || aligned16(t.L2));
        ring_rows(t.L, t.L2, t.R, tl.n, B, tl.r0, tl.TR, t.R, lvec,
                  reinterpret_cast<float*>(st + u.stage_bytes), lane,
                  &full[s]);
        if (!same_strip(e, prev)) {
          // the strip's gradients, once the sums of the strip that last
          // used the buffer are done
          const int b = strips % nb, use = strips / nb;
          if (use > 0) mbar_wait(&r_free[b], (use - 1) & 1);
          ring_grads(t, tl, B, rbuf + b * u.r_floats, &r_full[b], lane);
          ++strips;
        }
        prev = e;
        e = next;
      }
    }
    bulk_wait_all();
    return;
  }

  int strips = 0;      // strips begun
  bool first = true;   // item k starts a strip
  int4 e = entry(0);
  for (int k = 0; k < cnt; ++k) {
    const int4 next = entry(k + 1);   // in flight during this item
    const RingTile tl(T, e, tid);
    const UpdTensor& t = T[tl.slot];
    const float lr0 = u.lr[tl.n], pen0 = u.wpen[tl.n];   // read by Adam
    const bool last = !same_strip(e, next);
    const int s = k % S;
    char* const st = ring + s * sbytes;
    if (first) {
      mbar_wait(&r_full[strips % nb], (strips / nb) & 1);
      ++strips;
    }
    const int rb = (strips - 1) % nb;
    const float* const rs = rbuf + rb * u.r_floats;
    mbar_wait(&full[s], (k / S) & 1);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (tl.active) {
      const float* ls = reinterpret_cast<const float*>(st + u.stage_bytes);
      for (int p = 0; p < (t.L2 ? 2 : 1); ++p)
        upd_sums<BF16>(ls + p * B * tl.TR, tl.TR, rs + p * B * tl.TC, tl.TC,
                       B, tl.ly, tl.rx, acc);
    }
    if (last) {   // the strip's gradients are free
      __syncwarp();
      if (lane == 0) mbar_arrive(&r_free[rb]);
    }
    // L2 + Adam, W, m, v in the stage (or in place) and back
    const float alpha = adam.alpha(lr0), es2 = adam.es2, l2 = t.pen * pen0;
    const int mb = sizeof(MT);
    MT* const mp = static_cast<MT*>(t.m);
    MT* const vp = static_cast<MT*>(t.v);
    const bool vw = t.C % 4 == 0 && aligned16(t.W) && aligned16(t.m)
                    && aligned16(t.v);
    const int nc = tl.active ? max(0, min(4, tl.tc - tl.rx)) : 0;
    const int rows = nc ? min(4, tl.tr - tl.ly) : 0;
    char* const pw = st + 4 * (tl.ly * tl.ld + tl.rx);
    char* const pm = st + tl.TR * tl.ld * 4 + mb * (tl.ly * tl.ld + tl.rx);
    char* const pv = pm + tl.TR * tl.ld * mb;
    const int64_t o = ((int64_t)tl.n * t.R + tl.r0 + tl.ly) * t.C + tl.c0
                      + tl.rx;
    // every row's W, m and v read before any is written back
    float w[4][4], m[4][4], v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= rows) continue;
      if (t.ring) {
        moments_in(pw + 4 * i * tl.ld, static_cast<const float*>(nullptr),
                   w[i]);
        moments_in(pm + mb * i * tl.ld, mp, m[i]);
        moments_in(pv + mb * i * tl.ld, vp, v[i]);
      } else {
        load_row(t.W + o + i * t.C, w[i], nc, vw);
        load_row(mp + o + i * t.C, m[i], nc, vw);
        load_row(vp + o + i * t.C, v[i], nc, vw);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= rows) continue;
      float wn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wn[j] = adam_step(w[i][j], acc[i][j] + l2 * w[i][j], m[i][j],
                          v[i][j], alpha, es2);
      if (t.ring) {
        moments_out(pw + 4 * i * tl.ld, static_cast<const float*>(nullptr),
                    wn);
        moments_out(pm + mb * i * tl.ld, mp, m[i]);
        moments_out(pv + mb * i * tl.ld, vp, v[i]);
      } else {
        store_row(t.W + o + i * t.C, wn, nc, vw);
        store_row(mp + o + i * t.C, m[i], nc, vw);
        store_row(vp + o + i * t.C, v[i], nc, vw);
      }
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&done[s]);
    first = last;
    e = next;
  }
  upd_biases<MT>(u, T, adam);
}

// The in-place path (depth 0: phase 2's batch of 100): WTHREADS threads, two
// buffers of upd_deep_rows(B) batch rows in dynamic shared memory, each
// chunk staged by every thread; an item's own W, m, v are read into
// registers at its start, in flight during its sums.
template <typename MT, bool BF16>
__device__ __forceinline__ void update_in_place(const UpdArgs& u,
                                                const UpdTensor* T,
                                                const AdamScalars& adam) {
  extern __shared__ __align__(16) float upd_rows[];
  float (*buf)[UPD_LD] = reinterpret_cast<float (*)[UPD_LD]>(upd_rows);
  const int tid = threadIdx.x, B = u.B, ch = upd_deep_rows(B);
  const int chunks = (B + ch - 1) / ch;

  // Stage chunk q (pair q / chunks) of item ``tl`` into ``dst``: the layer
  // input's TR rows, then the gradient's TC columns.  A thread copies one
  // column piece of every pass-th row: one division a chunk where a loop
  // over the chunk's copies takes one a copy.
  auto stage = [&](const UpdTile& tl, int q, float (*dst)[UPD_LD]) {
    const UpdTensor& t = T[tl.slot];
    const int pair = q / chunks, b0 = (q % chunks) * ch;
    const float* lp = (pair ? t.L2 : t.L) + (int64_t)tl.n * B * t.R;
    const float* rp = (pair ? t.R2 : t.Rm) + (int64_t)tl.n * B * t.C;
    const int TR = tl.TR, W = tl.TR + tl.TC;
    const bool vec = t.R % 4 == 0 && t.C % 4 == 0 && aligned16(t.L)
                     && aligned16(t.Rm)
                     && (!t.L2 || (aligned16(t.L2) && aligned16(t.R2)));
    const int step = vec ? 4 : 1, per = W / step;
    const int pass = WTHREADS / per, bt = tid / per;
    const int j = (tid - bt * per) * step;
    const bool lft = j < TR;
    const int jj = lft ? tl.r0 + j : tl.c0 + j - TR;
    const bool jin = jj < (lft ? t.R : t.C);
    const int64_t ld = lft ? t.R : t.C;
    const float* base = (lft ? lp : rp) + jj;
    // threads past the last whole pass copy nothing
    for (int b = bt < pass ? bt : ch; b < ch; b += pass) {
      const int gb = b0 + b;
      const bool in = jin && gb < B;
      const float* src = base + gb * ld;
      if (vec)
        cp_async16(&dst[b][j], in ? src : lp, in ? 16 : 0);
      else
        cp_async4(&dst[b][j], in ? src : lp, in ? 4 : 0);
    }
    cp_async_commit();
  };

  int q = 0;   // chunks staged by this block so far: buffer q & 1
  const int G = gridDim.x;
  int item = blockIdx.x;
  const int4 none = make_int4(0, 0, 0, 0);
  int4 it_cur = item < u.n_weight ? u.items[item] : none;
  int4 it_next = item + G < u.n_weight ? u.items[item + G] : none;
  if (item < u.n_weight) stage(UpdTile(T, it_cur, tid), 0, buf);
  for (; item < u.n_weight; item += G) {
    const UpdTile tl(T, it_cur, tid);
    const UpdTensor& t = T[tl.slot];
    const int next = item + G;
    // the entry after next, read now and used one item later
    const int4 it_after = next + G < u.n_weight ? u.items[next + G] : none;
    const int steps = (t.L2 ? 2 : 1) * chunks;
    WmvTile<MT> cur;
    cur.load(t, tl);   // in flight during the sums
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    for (int s = 0; s < steps; ++s, ++q) {
      if (s + 1 < steps) {
        stage(tl, s + 1, buf + ((q + 1) & 1) * ch);
        cp_async_wait<1>();
      } else if (next < u.n_weight) {
        // the next item's first chunk, in flight during this item's last
        // sums and its epilogue
        stage(UpdTile(T, it_next, tid), 0, buf + ((q + 1) & 1) * ch);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (tl.active) {
        const float* bq = &buf[(q & 1) * ch][0];
        upd_sums<BF16>(bq, UPD_LD, bq, UPD_LD, min(ch, B - (s % chunks) * ch),
                       tl.row0 - tl.r0, tl.TR + tl.col0 - tl.c0, acc);
      }
      __syncthreads();   // the buffer is free for chunk q + 2
    }
    upd_adam<MT>(t, tl, cur, acc, adam.alpha(u.lr[tl.n]), adam.es2,
                 t.pen * u.wpen[tl.n]);
    it_cur = it_next;
    it_next = it_after;
  }
  upd_biases<MT>(u, T, adam);
}

// The in-place path on WTHREADS threads (INPLACE: a plan of depth 0),
// else the ring path on UPD_BLOCK.
template <typename MT, bool BF16, bool INPLACE>
__global__ void __launch_bounds__(INPLACE ? WTHREADS : UPD_BLOCK,
                                  INPLACE ? 2 : 1)
update_group_kernel(const UpdArgs u) {
  __shared__ UpdTensor T[UPD_SLOTS];
  for (int i = threadIdx.x; i < (int)(sizeof(T) / 4); i += blockDim.x)
    reinterpret_cast<int*>(T)[i] = reinterpret_cast<const int*>(u.T)[i];
  __syncthreads();
  const AdamScalars adam(u.st);
  if constexpr (INPLACE)
    update_in_place<MT, BF16>(u, T, adam);
  else
    update_ring<MT, BF16>(u, T, adam);
}

// ------------------------------------------------------- host helpers
constexpr int MAX_DEVICES = 64;

static bool aligned_host(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Streaming multiprocessors of the current device (132 if unknown).  The
// host helpers are static: a function-local static of an inline function
// would be one object across the three training libraries in a process.
static int device_sms() {
  static int sms[MAX_DEVICES] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0
      || device >= MAX_DEVICES)
    return 132;
  if (!sms[device] && cudaDeviceGetAttribute(
          &sms[device], cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 132;
  return sms[device];
}

// One batch-product launch: grid (panels of pw columns, row blocks, N),
// ceil(M / B_RPT) thread rows (at most B_TY) of pw / 4 threads, the ring
// sized to the panel.
template <int EPI, bool BF16>
static cudaError_t launch_gemm_batch(const GemmArgs& g, const EpiArgs& e,
                                     int pw, int n_inst,
                                     cudaStream_t stream) {
  const int ty_rows = ((g.M < BR ? g.M : BR) + B_RPT - 1) / B_RPT;
  const int math_warps = ((pw / 4) * ty_rows + 31) / 32;
  const dim3 grid((g.ncol + pw - 1) / pw, (g.M + BR - 1) / BR, n_inst);
  const size_t smem = BSTAGES * batch_stage_bytes(pw);
  gemm_batch_kernel<EPI, BF16><<<grid, 32 * (math_warps + 1), smem,
                                 stream>>>(g, e, pw, ty_rows);
  return cudaGetLastError();
}

// One register-tile product launch: grid (panels of pw columns, row
// blocks of TM_MAX, N), ceil(M / TR) thread rows (at most TM_MAX / TR) of
// pw / TC threads, the ring sized to the panel and the rows; the dynamic
// shared-memory limit raised once per device and instantiation.
template <int EPI, bool BF16, int TC>
static cudaError_t launch_gemm_tile(const GemmArgs& g, const EpiArgs& e,
                                    int pw, int n_inst,
                                    cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0
      || device >= MAX_DEVICES)
    return cudaErrorInvalidDevice;
  constexpr int max_smem =
      TSTAGES * tile_stage_floats(TM_MAX / TR, TPW_MAX, true) * 4;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tile_kernel<EPI, BF16, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  const int ty_rows = ((g.M < TM_MAX ? g.M : TM_MAX) + TR - 1) / TR;
  const int threads = ty_rows * (pw / TC);
  if (pw % TC || pw / TC < 2 || pw > TPW_MAX || threads > TT_MAX)
    return cudaErrorInvalidValue;
  const dim3 grid((g.ncol + pw - 1) / pw, (g.M + TM_MAX - 1) / TM_MAX,
                  n_inst);
  const size_t smem = TSTAGES * tile_stage_floats(ty_rows, pw, g.b_kmajor)
                      * sizeof(float);
  gemm_tile_kernel<EPI, BF16, TC><<<grid, threads, smem, stream>>>(
      g, e, pw, ty_rows);
  return cudaGetLastError();
}

// The grouped update: as many persistent blocks as fit the SMs (or one an
// item) at the launch's shared memory, the limit raised and the occupancy
// asked once per device, instantiation and size.
template <typename MT, bool BF16, bool INPLACE>
static cudaError_t launch_update_group(const UpdArgs& u,
                                       cudaStream_t stream) {
  if (!INPLACE && (u.depth < 2 || u.depth > UPD_DEPTH_MAX || u.B > WBK
                   || u.l_floats < 4 || u.l_floats % 4 || u.r_floats < 4
                   || u.r_floats % 4 || u.r_bufs < 1 || u.r_bufs > 2
                   || u.stage_bytes < 16 || u.stage_bytes % 16))
    return cudaErrorInvalidValue;
  const int threads = INPLACE ? WTHREADS : UPD_BLOCK;
  const int smem = INPLACE ? 2 * upd_deep_rows(u.B) * UPD_LD * 4
                           : upd_smem_bytes(u.depth, u.l_floats, u.r_floats,
                                            u.r_bufs, u.stage_bytes);
  static int raised[MAX_DEVICES] = {}, asked[MAX_DEVICES] = {},
             occ[MAX_DEVICES] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0
      || device >= MAX_DEVICES)
    return cudaErrorInvalidDevice;
  if (smem > raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        update_group_kernel<MT, BF16, INPLACE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[device] = smem;
  }
  if (asked[device] != smem) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, update_group_kernel<MT, BF16, INPLACE>, threads, smem);
    if (err != cudaSuccess) return err;
    occ[device] = blocks > 0 ? blocks : 1;
    asked[device] = smem;
  }
  const long long cap = (long long)occ[device] * device_sms();
  const long long blocks = u.n_items < cap ? u.n_items : cap;
  if (blocks <= 0) return cudaErrorInvalidValue;
  update_group_kernel<MT, BF16, INPLACE>
      <<<(unsigned)blocks, threads, smem, stream>>>(u);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launcher
// Enqueues the kernels above for ``n_inst`` instances of batch ``batch`` on
// stream ``s``.  mark() after every launch checks it, adds one to
// ``*launches`` and, with ``prof``, records a CUDA event tagged with the
// launch's type, so a step's launches can be timed type by type.
constexpr int MAX_EVENTS = 48;

struct Launcher {
  int n_inst, batch;
  cudaStream_t s;
  long long* launches;
  float* prof;
  cudaEvent_t ev[MAX_EVENTS];
  int nev = 0;
  int types[MAX_EVENTS];
  float* per_launch = nullptr;   // with ``prof``: each launch's ms, in order

  cudaError_t create_events() {
    if (!prof) return cudaSuccess;
    for (int i = 0; i < MAX_EVENTS; ++i) {
      const cudaError_t err = cudaEventCreate(&ev[i]);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
  void destroy_events() {
    if (prof)
      for (int i = 0; i < MAX_EVENTS; ++i) cudaEventDestroy(ev[i]);
  }
  void begin_step() {
    nev = 0;
    if (prof) cudaEventRecord(ev[0], s);
  }
  // With ``prof``: wait for the step and add each launch's time to its
  // type's slot.
  cudaError_t end_step() {
    if (!prof) return cudaSuccess;
    const cudaError_t err = cudaEventSynchronize(ev[nev]);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < nev; ++i) {
      float ms = 0.f;
      cudaEventElapsedTime(&ms, ev[i], ev[i + 1]);
      prof[types[i]] += ms;
      if (per_launch) per_launch[i] += ms;
    }
    return cudaSuccess;
  }

  cudaError_t mark(int type) {   // after a launch
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
    if (prof) {
      if (nev + 1 >= MAX_EVENTS) return cudaErrorInvalidValue;
      types[nev] = type;
      err = cudaEventRecord(ev[nev + 1], s);
      ++nev;
    }
    return err;
  }

  Mat act(const float* buf, int width) const {   // (N, B, width)
    return Mat{buf, (int64_t)batch * width, width, 1};
  }
  // an (N, rows, cols) weight, or its transpose (cols x rows)
  static Mat w_mat(const float* w, int rows, int cols, bool transposed) {
    const int64_t bs = (int64_t)rows * cols;
    return transposed ? Mat{w, bs, 1, cols} : Mat{w, bs, cols, 1};
  }

  // A product's arguments: B's orientation and whether every staged row
  // is 16-byte aligned; false where the operands do not lie as the
  // product blocks read them.
  bool gemm_args(int ncol, int K, Mat A, Mat B, int K2, Mat A2, Mat B2,
                 GemmArgs* g) const {
    if (K2 <= 0) { K2 = 0; A2 = A; B2 = B; }
    const bool kmajor = B.rs == 1 && B.cs != 1;
    // A is an activation, K-contiguous; both pairs' B lie alike
    if (A.cs != 1 || A2.cs != 1 || (B2.rs == 1 && B2.cs != 1) != kmajor)
      return false;
    auto rows16 = [](const Mat& a, int64_t step) {
      return aligned_host(a.p) && a.bs % 4 == 0 && step % 4 == 0;
    };
    const bool vec = K % 4 == 0 && K2 % 4 == 0 && rows16(A, A.rs)
                     && rows16(A2, A2.rs)
                     && (kmajor ? rows16(B, B.cs) && rows16(B2, B2.cs)
                                : rows16(B, B.rs) && rows16(B2, B2.rs)
                                  && ncol % 4 == 0);
    *g = GemmArgs{batch, ncol, K, K2, A, B, A2, B2, vec, kmajor};
    return true;
  }

  // A product on gemm_batch_kernel, in panels of ``pw`` columns (64, 32
  // or 16).
  template <int EPI>
  cudaError_t gemm_batch(int type, int pw, int ncol, int K, Mat A, Mat B,
                         int K2, Mat A2, Mat B2, const EpiArgs& e) {
    GemmArgs g;
    if (!gemm_args(ncol, K, A, B, K2, A2, B2, &g)
        || (pw != BPW && pw != 32 && pw != 16))
      return cudaErrorInvalidValue;
    cudaError_t err;
    if constexpr (TRAIN_BF16_OPERANDS) {
      err = e.bf16 ? launch_gemm_batch<EPI, true>(g, e, pw, n_inst, s)
                   : launch_gemm_batch<EPI, false>(g, e, pw, n_inst, s);
    } else {
      err = e.bf16 ? cudaErrorInvalidValue
                   : launch_gemm_batch<EPI, false>(g, e, pw, n_inst, s);
    }
    if (err != cudaSuccess) return err;
    return mark(type);
  }

  // A product on gemm_tile_kernel, in panels of ``pw`` columns and thread
  // tiles of TR x ``tc`` (8 or 4).
  template <int EPI>
  cudaError_t gemm_tile(int type, int pw, int tc, int ncol, int K, Mat A,
                        Mat B, int K2, Mat A2, Mat B2, const EpiArgs& e) {
    GemmArgs g;
    if (!gemm_args(ncol, K, A, B, K2, A2, B2, &g) || (tc != 8 && tc != 4))
      return cudaErrorInvalidValue;
    cudaError_t err;
    if constexpr (TRAIN_BF16_OPERANDS) {
      if (e.bf16)
        err = tc == 8 ? launch_gemm_tile<EPI, true, 8>(g, e, pw, n_inst, s)
                      : launch_gemm_tile<EPI, true, 4>(g, e, pw, n_inst, s);
      else
        err = tc == 8 ? launch_gemm_tile<EPI, false, 8>(g, e, pw, n_inst, s)
                      : launch_gemm_tile<EPI, false, 4>(g, e, pw, n_inst, s);
    } else {
      err = e.bf16 ? cudaErrorInvalidValue
            : tc == 8 ? launch_gemm_tile<EPI, false, 8>(g, e, pw, n_inst, s)
                      : launch_gemm_tile<EPI, false, 4>(g, e, pw, n_inst, s);
    }
    if (err != cudaSuccess) return err;
    return mark(type);
  }

  template <typename MT>
  cudaError_t update_group(int type, const UpdArgs& u, int bf16 = 0) {
    cudaError_t err;
    const bool in_place = u.depth == 0;
    if constexpr (TRAIN_BF16_OPERANDS) {
      if (in_place)
        err = bf16 ? launch_update_group<MT, true, true>(u, s)
                   : launch_update_group<MT, false, true>(u, s);
      else
        err = bf16 ? launch_update_group<MT, true, false>(u, s)
                   : launch_update_group<MT, false, false>(u, s);
    } else {
      err = bf16 ? cudaErrorInvalidValue
            : in_place ? launch_update_group<MT, false, true>(u, s)
                       : launch_update_group<MT, false, false>(u, s);
    }
    if (err != cudaSuccess) return err;
    return mark(type);
  }

};

#define TRAIN_TRY(call) do { cudaError_t e_ = (call); \
    if (e_ != cudaSuccess) return e_; } while (0)

}  // namespace train
