// The depth-2 DAE/VAE training run of a whole shape bucket, for sm_90a.
//
// Replaces the Pallas TPU kernel multimodalautoencoder_tpu/ops/
// train_kernel.py::_train_kernel (driven by _pipeline, pallas_call :1071),
// which ran one (config, fold) instance's whole S-step run inside one grid
// cell, with its parameters and Adam moments resident in VMEM.  One
// instance does not fit an SM here (tied 1000->100 is 4.4 MB of f32
// weights against 227 KB of shared memory), so the design is different:
//
// - every instance's parameters and Adam moments live in device memory,
//   stacked (N, rows, cols), and are updated in place;
// - each step is a fixed sequence of launches over all N instances, the
//   instance being a grid dimension (blockIdx.z or .y):
//     1. sample + corrupt             -> x, xn            (N, B, F)
//     2. forward products, bias, activation and dropout in the epilogue,
//        keeping the dropped activation and d * act'(z) for backward;
//     3. backward data products against W^T, with that factor in the
//        epilogue; the logit gradient sigmoid(z4) - x is the epilogue of
//        the z4 product, so z4 is never stored;
//     4. weight gradient + L2 + rsqrt Adam in one kernel: output-stationary
//        over a 64 x 64 tile of W with depth B, summing both products of a
//        tied weight; it reads W, m, v once and writes them once, and the
//        gradient never goes to device memory;
//     5. bias gradient (column sums over B) + Adam;
// - the S-step loop runs in C (mmae_train_run), one call per run, the way
//   the Pallas kernel is one invocation per run.  It counts its launches.
//
// Every product is computed here, on the CUDA cores in f32: no cuBLAS, no
// tensor cores, no TMA yet.  Random numbers come from Philox4x32-10
// (philox.cuh), keyed by (instance seed, purpose) with counter (step, row,
// column, draw); the plain PyTorch twin draws the same bits
// (ops/train_kernels.train_grid_kernel_reference).
//
// What bounds it on an H100 (tied 1000 -> 100 bucket, N = 60, B = 20,
// 1.10 M parameters per instance): the step must stream W, m and v in and
// out, 4+2+2 bytes each way per parameter with bf16 moments (16 B, 1.06 GB
// a step, 0.32 ms at 3.35 TB/s; 24 B and 0.47 ms with f32 moments), and
// do 2.2e8 FLOP per instance (1.35e10 a step, 0.20 ms at 67 TFLOP/s f32).
// The products have M = B = 20 rows, 40 FLOP per weight element read:
// above the f32 ridge of ~20 FLOP/B only if the CUDA cores run near peak,
// which this simple version does not.  ops/train_kernels.step_bound()
// computes the bound from the shapes.
//
// Semantics are the Pallas kernel's, not XLA's (ROADMAP Queue 3):
// - element corruption is Bernoulli at the marginal rate
//   elem_p = 1 - (1 - 1/F)^k, not k draws with replacement;
// - Adam stores m and v rounded to bf16 when asked, but updates the weight
//   with this step's unrounded f32 m and v (train_kernel.py:358-363);
// - the VAE's KL is taken on the sampled z; g4 uses the clean batch x as
//   target, -1 gap values included (the reference's objective).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

// Parameter slots, in the Pallas kernel's argument order.
enum Slot { W1 = 0, B1, W2, B2, W3, B3, W4, B4, WV, BV, NSLOT };
// Workspace buffers (N, B, width).
enum Buf { X = 0, XN, A1D, GF1, MU, LV, EPS, Z2, A3D, GF3, G4, G3, GZ, GLV,
           G1, NBUF };
// Launch types, for the profile of one step.
enum Prof { P_SAMPLE = 0, P_FWD, P_VAE, P_BWD, P_WADAM, P_BADAM, NPROF };

}  // namespace

extern "C" {
// Mirrored field for field by ops/train_kernels.TrainArgs (ctypes).
struct TrainArgs {
  int n_inst, batch, feats, h1, h2, n_types, max_rows;
  int tied, variational, bf16_moments, decay;
  float elem_p, mask_value, decay_steps, decay_rate;
  const int* seeds;        // (N,) instance seeds, >= 0
  const int* fold;         // (N,)
  const int* n_valid;      // (N,) train rows of the instance's fold
  const float* lr;         // (N,)
  const float* keep;       // (N,) keep probability
  const float* wpen;       // (N,) L2 weight penalty
  const int* act;          // (N,) activation id (config.ACTIVATIONS order)
  const float* train;      // (K, max_rows, F) fold train rows
  const float* type_table; // (T, F) 1 where a modality set masks a feature
  const float* cum;        // (T,) cumulative modality-set probabilities
  float* param[10];        // slot -> (N, rows, cols) or (N, cols); null if absent
  void* m[10];             // Adam first moments, f32 or bf16, like param
  void* v[10];             // Adam second moments
  float* ws[15];           // workspace, Buf order
};
}

namespace {

constexpr float ADAM_B1 = 0.9f, ADAM_1MB1 = 0.1f;
constexpr float ADAM_B2 = 0.999f, ADAM_1MB2 = 0.001f;
constexpr float ADAM_EPS2 = 1e-16f;   // eps^2 with eps = 1e-8

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
struct AdamStep { int step, decay; float decay_steps, decay_rate; };

__device__ __forceinline__ void adam_scalars(const AdamStep& st, float lr0,
                                             float* alpha, float* es2) {
  const float cf = (float)(st.step + 1);
  const float bc1 = 1.f - powf(ADAM_B1, cf);
  const float bc2 = 1.f - powf(ADAM_B2, cf);
  const float lr = st.decay
      ? lr0 * powf(st.decay_rate, (float)st.step / st.decay_steps) : lr0;
  *alpha = lr * sqrtf(bc2) / bc1;
  *es2 = bc2 * ADAM_EPS2;
}

template <typename MT>
__device__ __forceinline__ float adam_apply(float w, float g, MT* m, MT* v,
                                            float alpha, float es2) {
  const float mn = ADAM_B1 * load_m(m) + ADAM_1MB1 * g;
  const float vn = ADAM_B2 * load_m(v) + ADAM_1MB2 * g * g;
  store_m(m, mn);
  store_m(v, vn);
  return w - (alpha * mn) * rsqrtf(vn + es2);   // unrounded m, v
}

// ---------------------------------------------------------------- sample
// grid (B, N): one block per batch row.  The row is drawn uniformly with
// replacement from the fold's n_valid train rows; the modality set from
// the cumulative probabilities (t == T: nothing masked); element zeros at
// rate elem_p, then the set's span overwritten with mask_value.
__global__ void sample_corrupt_kernel(TrainArgs a, int step) {
  const int b = blockIdx.x, n = blockIdx.y;
  const uint32_t seed = (uint32_t)a.seeds[n];
  __shared__ int s_row, s_type;
  if (threadIdx.x == 0) {
    s_row = philox::index_below(
        philox::bits(seed, philox::ROW, step, b, 0), (uint32_t)a.n_valid[n]);
    const float u = philox::uniform(
        philox::bits(seed, philox::TYPE, step, b, 0));
    int t = 0;
    for (int j = 0; j < a.n_types; ++j) t += (u >= a.cum[j]) ? 1 : 0;
    s_type = t;
  }
  __syncthreads();
  const int F = a.feats;
  const float* src = a.train + ((int64_t)a.fold[n] * a.max_rows + s_row) * F;
  const int64_t o = ((int64_t)n * a.batch + b) * F;
  const float* mask = s_type < a.n_types ? a.type_table + (int64_t)s_type * F
                                         : nullptr;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float v = src[f];
    float w = v;
    if (a.elem_p > 0.f &&
        philox::uniform(philox::bits(seed, philox::ELEM, step, b, f))
            < a.elem_p)
      w = 0.f;
    if (mask && mask[f] > 0.f) w = a.mask_value;
    a.ws[X][o + f] = v;
    a.ws[XN][o + f] = w;
  }
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
};

template <int EPI>
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
        as[k][r] = (gr < M && gk < kt) ? ap[gr * a.rs + gk * a.cs] : 0.f;
      }
      for (int i = tid; i < GK * GN; i += GT) {
        const int c = b_c_fast ? i % GN : i / GK;
        const int k = b_c_fast ? i / GN : i % GK;
        const int gk = k0 + k, gc = c0 + c;
        bs[k][c] = (gk < kt && gc < ncol) ? bp[gk * b.rs + gc * b.cs] : 0.f;
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

// ------------------------------------------------------- VAE elementwise
// z2 = mu + eps * exp(lv), eps by Box-Muller (multimodal_autoencoder.py
// :372-375).
__global__ void vae_sample_kernel(TrainArgs a, int step) {
  const int64_t total = (int64_t)a.n_inst * a.batch * a.h2;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % a.h2);
    const int b = (int)((i / a.h2) % a.batch);
    const int n = (int)(i / ((int64_t)a.h2 * a.batch));
    const float eps = philox::normal((uint32_t)a.seeds[n], philox::EPS, step,
                                     b, j);
    a.ws[EPS][i] = eps;
    a.ws[Z2][i] = a.ws[MU][i] + eps * expf(a.ws[LV][i]);
  }
}

// KL on the sampled z (reference :402-406): gz += z2 / B,
// glv = gz * eps * sigma + (e^{2 lv} - 1) / B.
__global__ void vae_grad_kernel(TrainArgs a) {
  const int64_t total = (int64_t)a.n_inst * a.batch * a.h2;
  const float inv_b = 1.f / (float)a.batch;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float lv = a.ws[LV][i];
    const float gz = a.ws[GZ][i] + a.ws[Z2][i] * inv_b;
    a.ws[GZ][i] = gz;
    a.ws[GLV][i] = gz * a.ws[EPS][i] * expf(lv)
                   + (expf(2.f * lv) - 1.f) * inv_b;
  }
}

// ------------------------------------------------- weight grad + Adam
// W[n] (R x C) -= Adam(L[n]^T R[n] [+ L2[n]^T R2[n]] + pen * wpen * W),
// L (B x R), R (B x C) contiguous.  Thread (tx, ty) owns column tx and rows
// ty, ty + 4, ... of a WT x WT tile.
constexpr int WT = 64, WB = 32, WR = WT / 4;

template <typename MT>
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
        ls[b][j] = (gb < Bsz && r0 + j < R) ? lp[(int64_t)gb * R + r0 + j]
                                            : 0.f;
        rs[b][j] = (gb < Bsz && c0 + j < C) ? rp[(int64_t)gb * C + c0 + j]
                                            : 0.f;
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

// ------------------------------------------------------------- the probe
// The in-kernel generator check (tests_tpu/test_hardware.py:28-40): row
// 2i + d holds draw d of counter i, 128 columns, seed ``seed``.
__global__ void philox_probe_kernel(float* out, int seed) {
  for (int e = threadIdx.x; e < 8 * 128; e += blockDim.x) {
    const int r = e / 128, j = e % 128;
    out[e] = philox::uniform(
        philox::bits((uint32_t)seed, philox::PROBE, r / 2, 0, j, r % 2));
  }
}

// ------------------------------------------------------------- the host loop
struct Runner {
  const TrainArgs& a;
  cudaStream_t s;
  long long* launches;
  float* prof;
  cudaEvent_t ev[32];
  int nev = 0;
  int types[32];

  cudaError_t mark(int type) {   // after a launch
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
    if (prof) {
      types[nev] = type;
      err = cudaEventRecord(ev[nev + 1], s);
      ++nev;
    }
    return err;
  }

  Mat act_mat(int buf, int width) const {   // (N, B, width) contiguous
    return Mat{a.ws[buf], (int64_t)a.batch * width, width, 1};
  }
  Mat w_mat(int slot, int rows, int cols, bool transposed) const {
    // slot's (N, rows, cols) weight, or its transpose (cols x rows)
    const int64_t bs = (int64_t)rows * cols;
    return transposed ? Mat{a.param[slot], bs, 1, cols}
                      : Mat{a.param[slot], bs, cols, 1};
  }

  template <int EPI>
  cudaError_t gemm(int type, int ncol, int K, Mat A, Mat B, int K2, Mat A2,
                   Mat B2, EpiArgs e) {
    const dim3 grid((ncol + GN - 1) / GN, (a.batch + GM - 1) / GM, a.n_inst);
    gemm_rows_kernel<EPI><<<grid, GT, 0, s>>>(a.batch, ncol, K, A, B, K2, A2,
                                              B2, e);
    return mark(type);
  }

  template <typename MT>
  cudaError_t wadam(int slot, int R, int C, int l, int r, int l2, int r2,
                    float pen, AdamStep st) {
    const dim3 grid((C + WT - 1) / WT, (R + WT - 1) / WT, a.n_inst);
    wgrad_adam_kernel<MT><<<grid, 256, 0, s>>>(
        R, C, a.batch, a.ws[l], a.ws[r], l2 < 0 ? nullptr : a.ws[l2],
        r2 < 0 ? nullptr : a.ws[r2], a.param[slot], (MT*)a.m[slot],
        (MT*)a.v[slot], a.lr, a.wpen, pen, st);
    return mark(P_WADAM);
  }

  template <typename MT>
  cudaError_t badam(int slot, int C, int g, AdamStep st) {
    const dim3 grid((C + 255) / 256, a.n_inst);
    bias_adam_kernel<MT><<<grid, 256, 0, s>>>(
        C, a.batch, a.ws[g], a.param[slot], (MT*)a.m[slot], (MT*)a.v[slot],
        a.lr, st);
    return mark(P_BADAM);
  }

  template <typename MT>
  cudaError_t step(int t) {
#define TRY(call) do { cudaError_t e_ = (call); if (e_ != cudaSuccess) \
                         return e_; } while (0)
    const int F = a.feats, H1 = a.h1, H2 = a.h2;
    const bool tied = a.tied, vae = a.variational;
    const Mat none{nullptr, 0, 0, 0};
    const AdamStep st{t, a.decay, a.decay_steps, a.decay_rate};
    EpiArgs e{};
    e.seeds = a.seeds; e.act = a.act; e.keep = a.keep; e.step = t;

    sample_corrupt_kernel<<<dim3(a.batch, a.n_inst), 128, 0, s>>>(a, t);
    TRY(mark(P_SAMPLE));

    // forward: z1 = xn W1 + b1 -> a1d, gf1
    e.bias = a.param[B1]; e.out0 = a.ws[A1D]; e.out1 = a.ws[GF1];
    e.purpose = philox::DROP1;
    TRY(gemm<E_ACT_DROP>(P_FWD, H1, F, act_mat(XN, F),
                         w_mat(W1, F, H1, false), 0, none, none, e));
    // mu = a1d W2 + b2
    e.bias = a.param[B2]; e.out0 = a.ws[MU];
    TRY(gemm<E_BIAS>(P_FWD, H2, H1, act_mat(A1D, H1),
                     w_mat(W2, H1, H2, false), 0, none, none, e));
    if (vae) {
      e.bias = a.param[BV]; e.out0 = a.ws[LV];
      TRY(gemm<E_BIAS>(P_FWD, H2, H1, act_mat(A1D, H1),
                       w_mat(WV, H1, H2, false), 0, none, none, e));
      vae_sample_kernel<<<264, 256, 0, s>>>(a, t);
      TRY(mark(P_VAE));
    }
    const int z2 = vae ? Z2 : MU;
    // z3 = z2 W3 + b3 -> a3d, gf3 (W3 = W2^T when tied)
    const Mat w3 = tied ? w_mat(W2, H1, H2, true) : w_mat(W3, H2, H1, false);
    e.bias = a.param[B3]; e.out0 = a.ws[A3D]; e.out1 = a.ws[GF3];
    e.purpose = philox::DROP3;
    TRY(gemm<E_ACT_DROP>(P_FWD, H1, H2, act_mat(z2, H2), w3, 0, none, none,
                         e));
    // g4 = sigmoid(a3d W4 + b4) - x (W4 = W1^T when tied)
    const Mat w4 = tied ? w_mat(W1, F, H1, true) : w_mat(W4, H1, F, false);
    e.bias = a.param[B4]; e.aux = a.ws[X]; e.out0 = a.ws[G4];
    TRY(gemm<E_LOGIT_GRAD>(P_FWD, F, H1, act_mat(A3D, H1), w4, 0, none,
                           none, e));

    // backward: g3 = (g4 W4^T) * gf3
    const Mat w4t = tied ? w_mat(W1, F, H1, false) : w_mat(W4, H1, F, true);
    e.aux = a.ws[GF3]; e.out0 = a.ws[G3];
    TRY(gemm<E_MUL>(P_BWD, H1, F, act_mat(G4, F), w4t, 0, none, none, e));
    // gz = g3 W3^T
    const Mat w3t = tied ? w_mat(W2, H1, H2, false) : w_mat(W3, H2, H1, true);
    e.out0 = a.ws[GZ];
    TRY(gemm<E_NONE>(P_BWD, H2, H1, act_mat(G3, H1), w3t, 0, none, none, e));
    if (vae) {
      vae_grad_kernel<<<264, 256, 0, s>>>(a);
      TRY(mark(P_VAE));
    }
    // g1 = (gz W2^T [+ glv Wv^T]) * gf1
    e.aux = a.ws[GF1]; e.out0 = a.ws[G1];
    TRY(gemm<E_MUL>(P_BWD, H1, H2, act_mat(GZ, H2), w_mat(W2, H1, H2, true),
                    vae ? H2 : 0, vae ? act_mat(GLV, H2) : none,
                    vae ? w_mat(WV, H1, H2, true) : none, e));

    // weight gradients + L2 (doubled when tied) + Adam
    if (tied) {
      TRY(wadam<MT>(W1, F, H1, XN, G1, G4, A3D, 2.f, st));
      TRY(wadam<MT>(W2, H1, H2, A1D, GZ, G3, z2, 2.f, st));
    } else {
      TRY(wadam<MT>(W1, F, H1, XN, G1, -1, -1, 1.f, st));
      TRY(wadam<MT>(W2, H1, H2, A1D, GZ, -1, -1, 1.f, st));
      TRY(wadam<MT>(W3, H2, H1, z2, G3, -1, -1, 1.f, st));
      TRY(wadam<MT>(W4, H1, F, A3D, G4, -1, -1, 1.f, st));
    }
    if (vae) TRY(wadam<MT>(WV, H1, H2, A1D, GLV, -1, -1, 1.f, st));
    TRY(badam<MT>(B1, H1, G1, st));
    TRY(badam<MT>(B2, H2, GZ, st));
    TRY(badam<MT>(B3, H1, G3, st));
    TRY(badam<MT>(B4, F, G4, st));
    if (vae) TRY(badam<MT>(BV, H2, GLV, st));
#undef TRY
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// Steps [first_step, first_step + num_steps) of the bucket described by
// ``a``, on ``stream``.  Adds the launches it made to ``*launches``.  With
// ``prof_ms`` (NPROF floats) it also times every launch with CUDA events,
// synchronising once a step, and adds each launch type's milliseconds.
// Returns the first CUDA error (0 on success).
int mmae_train_run(const TrainArgs* a, int first_step, int num_steps,
                   long long* launches, float* prof_ms, void* stream) {
  if (a->n_inst <= 0 || num_steps <= 0) return 0;
  if (a->n_inst > 65535 || a->batch <= 0 || a->batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (!a->tied && (!a->param[W3] || !a->param[W4]))
    return (int)cudaErrorInvalidValue;
  if (a->variational && (!a->param[WV] || !a->param[BV]))
    return (int)cudaErrorInvalidValue;
  Runner r{*a, static_cast<cudaStream_t>(stream), launches, prof_ms};
  if (prof_ms) {
    for (int i = 0; i < 32; ++i) {
      cudaError_t err = cudaEventCreate(&r.ev[i]);
      if (err != cudaSuccess) return (int)err;
    }
  }
  cudaError_t err = cudaSuccess;
  for (int t = first_step; t < first_step + num_steps; ++t) {
    r.nev = 0;
    if (prof_ms) cudaEventRecord(r.ev[0], r.s);
    err = a->bf16_moments ? r.step<__nv_bfloat16>(t) : r.step<float>(t);
    if (err != cudaSuccess) break;
    if (prof_ms) {
      err = cudaEventSynchronize(r.ev[r.nev]);
      if (err != cudaSuccess) break;
      for (int i = 0; i < r.nev; ++i) {
        float ms = 0.f;
        cudaEventElapsedTime(&ms, r.ev[i], r.ev[i + 1]);
        prof_ms[r.types[i]] += ms;
      }
    }
  }
  if (prof_ms)
    for (int i = 0; i < 32; ++i) cudaEventDestroy(r.ev[i]);
  return (int)err;
}

// (8, 128) float32 uniforms of the generator check into ``out``.
int philox_probe_launch(float* out, int seed, long long* launches,
                        void* stream) {
  philox_probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, seed);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return (int)err;
}

const char* train_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
