// Device code shared by the training kernels of csrc/train_kernel.cu (the
// phase-1 DAE/VAE run) and csrc/cls_train_kernel.cu (the phase-2
// classification run): activations, rsqrt Adam, the instance-batched
// small-M product with its epilogues, the weight-gradient + L2 + Adam
// kernel, the bias-gradient + Adam kernel, and a launcher that enqueues
// them on one stream, counts every launch and can time each with CUDA
// events.
//
// Every product runs on the CUDA cores in f32 (no cuBLAS, no tensor
// cores).  The BF16 instantiations round each product operand to bfloat16
// (nearest even) as it is staged, and the sums stay f32: the operand
// policy of the JAX package's mmae.mxu_dot.  It is a template parameter,
// so the f32 kernels carry no test for it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

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

__device__ __forceinline__ void adam_scalars(const AdamStep& st, float lr0,
                                             float* alpha, float* es2) {
  const float cf = (float)(st.step + 1);
  const float bc1 = 1.f - powf(ADAM_B1, cf);
  const float bc2 = 1.f - powf(ADAM_B2, cf);
  const float lr = st.decay
      ? lr0 * powf(st.decay_rate, (float)st.step / st.decay_steps) : lr0;
  *alpha = lr * sqrtf(bc2) / bc1;
  *es2 = bc2 * st.eps2;
}

// Moments are stored in their type (rounded when bf16), but the weight
// takes this step's unrounded f32 m and v, as the Pallas kernels do
// (train_kernel.py:358-363).
template <typename MT>
__device__ __forceinline__ float adam_apply(float w, float g, MT* m, MT* v,
                                            float alpha, float es2) {
  const float mn = ADAM_B1 * load_m(m) + ADAM_1MB1 * g;
  const float vn = ADAM_B2 * load_m(v) + ADAM_1MB2 * g * g;
  store_m(m, mn);
  store_m(v, vn);
  return w - (alpha * mn) * rsqrtf(vn + es2);
}

// ------------------------------------------------------------ products
// C[n] (M x ncol) = A[n] (M x K) . B[n] (K x ncol) [+ A2[n] . B2[n]],
// with small M (the batch).  A block owns GM rows x GN columns of one
// instance and walks K in GK-deep slices staged in shared memory along
// whichever axis of the operand is contiguous, so W^T views are read
// coalesced without a copy.  Thread (tx, ty) sums column tx of rows
// ty, ty + 4, ...
constexpr int GM = 32, GN = 64, GK = 32, GT = 256, GR = GM / 4;

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

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? round_bf16(v) : v;
}

template <int EPI, bool BF16>
__global__ void __launch_bounds__(GT)
gemm_rows_kernel(int M, int ncol, int K, Mat A, Mat B, int K2, Mat A2,
                 Mat B2, EpiArgs e) {
  __shared__ float as[GK][GM + 1];
  __shared__ float bs[GK][GN + 4];
  const int n = blockIdx.z, m0 = blockIdx.y * GM, c0 = blockIdx.x * GN;
  const int tid = threadIdx.x, tx = tid % GN, ty = tid / GN;
  const int nr = min(GR, (min(GM, M - m0) - ty + 3) / 4);   // rows owned
  float acc[GR];
#pragma unroll
  for (int i = 0; i < GR; ++i) acc[i] = 0.f;

  for (int pair = 0; pair < 2; ++pair) {
    const Mat a = pair ? A2 : A, b = pair ? B2 : B;
    const int kt = pair ? K2 : K;
    if (kt <= 0) continue;
    const float* ap = a.p + n * a.bs;
    const float* bp = b.p + n * b.bs;
    const bool a_k_fast = a.cs == 1, b_c_fast = b.cs == 1;
    for (int k0 = 0; k0 < kt; k0 += GK) {
      for (int i = tid; i < GM * GK; i += GT) {
        const int r = a_k_fast ? i / GK : i % GM;
        const int k = a_k_fast ? i % GK : i / GM;
        const int gr = m0 + r, gk = k0 + k;
        const float v = (gr < M && gk < kt) ? ap[gr * a.rs + gk * a.cs] : 0.f;
        as[k][r] = operand<BF16>(v);
      }
      for (int i = tid; i < GK * GN; i += GT) {
        const int c = b_c_fast ? i % GN : i / GK;
        const int k = b_c_fast ? i / GN : i % GK;
        const int gk = k0 + k, gc = c0 + c;
        const float v = (gk < kt && gc < ncol) ? bp[gk * b.rs + gc * b.cs]
                                               : 0.f;
        bs[k][c] = operand<BF16>(v);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < GK; ++k) {
        const float bv = bs[k][tx];
#pragma unroll
        for (int i = 0; i < GR; ++i)
          if (i < nr) acc[i] = fmaf(as[k][ty + 4 * i], bv, acc[i]);
      }
      __syncthreads();
    }
  }

  const int col = c0 + tx;
  if (col >= ncol) return;
  const float bias = (EPI == E_ACT_DROP || EPI == E_BIAS
                      || EPI == E_LOGIT_GRAD)
      ? e.bias[(int64_t)n * ncol + col] : 0.f;
  int act = 0;
  float keep = 1.f, inv_keep = 1.f;
  uint32_t seed = 0;
  if (EPI == E_ACT_DROP) {
    act = e.act[n];
    keep = e.keep[n];
    inv_keep = 1.f / keep;
    seed = (uint32_t)e.seeds[n];
  }
#pragma unroll
  for (int i = 0; i < GR; ++i) {
    if (i >= nr) break;
    const int row = m0 + ty + 4 * i;
    const int64_t o = ((int64_t)n * M + row) * ncol + col;
    const float s = acc[i];
    if (EPI == E_ACT_DROP) {
      const float z = s + bias;
      const float u = philox::uniform(
          philox::bits(seed, e.purpose, e.step, row, col));
      const float d = u < keep ? inv_keep : 0.f;
      e.out0[o] = act_fn(z, act) * d;
      e.out1[o] = d * act_grad(z, act);
    } else if (EPI == E_BIAS) {
      e.out0[o] = s + bias;
    } else if (EPI == E_LOGIT_GRAD) {
      const float z = s + bias;
      e.out0[o] = 1.f / (1.f + expf(-z)) - e.aux[o];
    } else if (EPI == E_MUL) {
      e.out0[o] = s * e.aux[o];
    } else {
      e.out0[o] = s;
    }
  }
}

// ------------------------------------------------- weight grad + Adam
// W[n] (R x C) -= Adam(L[n]^T R[n] [+ L2[n]^T R2[n]] + pen * wpen[n] * W),
// L (B x R), R (B x C) contiguous.  Thread (tx, ty) owns column tx and rows
// ty, ty + 4, ... of a WT x WT tile; the gradient stays in registers.
constexpr int WT = 64, WB = 32, WR = WT / 4;

template <typename MT, bool BF16>
__global__ void __launch_bounds__(256)
wgrad_adam_kernel(int R, int C, int Bsz, const float* L, const float* Rm,
                  const float* L2, const float* R2, float* W, MT* m, MT* v,
                  const float* lr, const float* wpen, float pen,
                  AdamStep st) {
  __shared__ float ls[WB][WT + 1];
  __shared__ float rs[WB][WT + 1];
  const int n = blockIdx.z, r0 = blockIdx.y * WT, c0 = blockIdx.x * WT;
  const int tid = threadIdx.x, tx = tid % WT, ty = tid / WT;
  float acc[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) acc[i] = 0.f;

  for (int pair = 0; pair < 2; ++pair) {
    const float* lp = pair ? L2 : L;
    const float* rp = pair ? R2 : Rm;
    if (!lp) continue;
    lp += (int64_t)n * Bsz * R;
    rp += (int64_t)n * Bsz * C;
    for (int b0 = 0; b0 < Bsz; b0 += WB) {
      for (int i = tid; i < WB * WT; i += 256) {
        const int b = i / WT, j = i % WT;
        const int gb = b0 + b;
        const float lv = (gb < Bsz && r0 + j < R)
            ? lp[(int64_t)gb * R + r0 + j] : 0.f;
        const float rv = (gb < Bsz && c0 + j < C)
            ? rp[(int64_t)gb * C + c0 + j] : 0.f;
        ls[b][j] = operand<BF16>(lv);
        rs[b][j] = operand<BF16>(rv);
      }
      __syncthreads();
      const int nb = min(WB, Bsz - b0);
      for (int b = 0; b < nb; ++b) {
        const float rv = rs[b][tx];
#pragma unroll
        for (int i = 0; i < WR; ++i)
          acc[i] = fmaf(ls[b][ty + 4 * i], rv, acc[i]);
      }
      __syncthreads();
    }
  }

  const int col = c0 + tx;
  if (col >= C) return;
  float alpha, es2;
  adam_scalars(st, lr[n], &alpha, &es2);
  const float l2 = pen * wpen[n];
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int row = r0 + ty + 4 * i;
    if (row >= R) break;
    const int64_t o = ((int64_t)n * R + row) * C + col;
    const float w = W[o];
    W[o] = adam_apply(w, acc[i] + l2 * w, m + o, v + o, alpha, es2);
  }
}

// --------------------------------------------------- bias grad + Adam
// b[n] (C) -= Adam(sum over the batch of G[n] (B x C)); no L2 on biases.
template <typename MT>
__global__ void bias_adam_kernel(int C, int Bsz, const float* G, float* bias,
                                 MT* m, MT* v, const float* lr, AdamStep st) {
  const int n = blockIdx.y, col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C) return;
  const float* g = G + (int64_t)n * Bsz * C + col;
  float s = 0.f;
  for (int b = 0; b < Bsz; ++b) s += g[(int64_t)b * C];
  float alpha, es2;
  adam_scalars(st, lr[n], &alpha, &es2);
  const int64_t o = (int64_t)n * C + col;
  bias[o] = adam_apply(bias[o], s, m + o, v + o, alpha, es2);
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

  template <int EPI>
  cudaError_t gemm(int type, int ncol, int K, Mat A, Mat B, int K2, Mat A2,
                   Mat B2, const EpiArgs& e) {
    const dim3 grid((ncol + GN - 1) / GN, (batch + GM - 1) / GM, n_inst);
    if (e.bf16)
      gemm_rows_kernel<EPI, true><<<grid, GT, 0, s>>>(batch, ncol, K, A, B,
                                                      K2, A2, B2, e);
    else
      gemm_rows_kernel<EPI, false><<<grid, GT, 0, s>>>(batch, ncol, K, A, B,
                                                       K2, A2, B2, e);
    return mark(type);
  }

  template <typename MT>
  cudaError_t wadam(int type, int R, int C, const float* l, const float* r,
                    const float* l2, const float* r2, float* w, void* m,
                    void* v, const float* lr, const float* wpen, float pen,
                    const AdamStep& st, int bf16) {
    const dim3 grid((C + WT - 1) / WT, (R + WT - 1) / WT, n_inst);
    if (bf16)
      wgrad_adam_kernel<MT, true><<<grid, 256, 0, s>>>(
          R, C, batch, l, r, l2, r2, w, (MT*)m, (MT*)v, lr, wpen, pen, st);
    else
      wgrad_adam_kernel<MT, false><<<grid, 256, 0, s>>>(
          R, C, batch, l, r, l2, r2, w, (MT*)m, (MT*)v, lr, wpen, pen, st);
    return mark(type);
  }

  template <typename MT>
  cudaError_t badam(int type, int C, const float* g, float* b, void* m,
                    void* v, const float* lr, const AdamStep& st) {
    const dim3 grid((C + 255) / 256, n_inst);
    bias_adam_kernel<MT><<<grid, 256, 0, s>>>(C, batch, g, b, (MT*)m,
                                              (MT*)v, lr, st);
    return mark(type);
  }
};

#define TRAIN_TRY(call) do { cudaError_t e_ = (call); \
    if (e_ != cudaSuccess) return e_; } while (0)

}  // namespace train
