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
//   instance being a grid dimension:
//     1. sample + corrupt             -> x, xn            (N, B, F)
//     2. forward products (gemm_batch_kernel), bias, activation and
//        dropout in the epilogue, keeping the dropped activation and
//        d * act'(z) for backward; the logit gradient sigmoid(z4) - x is
//        the epilogue of the z4 product, so z4 is never stored;
//     3. backward data products against W^T, with that factor in the
//        epilogue;
//     4. one grouped update (update_group_kernel) over a work list:
//        weight gradient + L2 + rsqrt Adam per weight, a tied weight
//        summing its encode product and its decode product transposed
//        with the L2 doubled, then bias gradient + Adam;
//   9 launches a tied or untied step, 12 for a VAE;
// - the S-step loop runs in C (mmae_train_run), one call per run, the way
//   the Pallas kernel is one invocation per run.  It counts its launches.
//   Each product's panel width and the update's work list come from the
//   host (ops/train_kernels.run_plan), once a run.
//
// Running the step group by group over instances, each group small
// enough to keep its f32 weights in the H100's 50 MB L2 from z1 to the
// update, was measured and lost to one launch over all N (PERF.md): the
// extra launches cost more than the repeated weight reads.
//
// Every product is computed here (train_common.cuh), in exact f32 FMAs
// in k order from a ring of cp.async copies: no cuBLAS.  Every sum keeps
// the order of the first CUDA-core kernels, so every parameter and moment
// is bit for bit theirs (chip_smoke.py --train-ab).  Random numbers come from
// Philox4x32-10 (philox.cuh), keyed by (instance seed, purpose) with
// counter (step, row, column, draw); the plain PyTorch twin draws the same
// bits (ops/train_kernels.train_grid_kernel_reference).
//
// What bounds it on an H100 (tied 1000 -> 100 bucket, N = 60, B = 20,
// 1.10 M parameters per instance): the step must stream W, m and v in and
// out, 4+2+2 bytes each way per parameter with bf16 moments (16 B, 1.06 GB
// a step, 0.32 ms at 3.35 TB/s; 24 B and 0.47 ms with f32 moments), and
// do 2.2e8 FLOP per instance (1.35e10 a step, 0.20 ms at 67 TFLOP/s f32).
// The products have M = B = 20 rows, 40 FLOP per weight element read:
// above the f32 ridge of ~20 FLOP/B only if the CUDA cores run near peak.
// The grouped update reads and writes every W, m and v element for 2 B =
// 40 FLOP: bytes bound it, so at B = 20 it streams them through a
// shared-memory ring by bulk copies, a copy warp keeping the next items'
// W, m and v in flight and writing the last ones back while the update
// threads sum (train_common.cuh), where 64 x 64 register tiles loaded
// one item ahead read them in bursts (56-57 % of its bound, PERF.md).  ops/train_kernels.step_bound() computes the bound from the
// shapes, and launch_bounds() each launch's own.
//
// Semantics are the Pallas kernel's, not XLA's (ROADMAP Queue 3):
// - element corruption is Bernoulli at the marginal rate
//   elem_p = 1 - (1 - 1/F)^k, not k draws with replacement;
// - Adam stores m and v rounded to bf16 when asked, but updates the weight
//   with this step's unrounded f32 m and v (train_kernel.py:358-363);
// - the VAE's KL is taken on the sampled z; g4 uses the clean batch x as
//   target, -1 gap values included (the reference's objective).

#include "train_common.cuh"

namespace {

// Parameter slots, in the Pallas kernel's argument order.
enum Slot { W1 = 0, B1, W2, B2, W3, B3, W4, B4, WV, BV, NSLOT };
static_assert(NSLOT <= train::UPD_SLOTS, "the update's descriptor table");
// Workspace buffers (N, B, width).
enum Buf { X = 0, XN, A1D, GF1, MU, LV, EPS, Z2, A3D, GF3, G4, G3, GZ, GLV,
           G1, NBUF };
// Launch types, for the profile of one step (the grouped update is
// P_WADAM).
enum Prof { P_SAMPLE = 0, P_FWD, P_VAE, P_BWD, P_WADAM, P_BADAM, NPROF };
// A step's products: z1, lv (VAE), mu, z3, z4, g3, gz, g1.
constexpr int MAX_PRODUCTS = 8;

}  // namespace

extern "C" {
// Mirrored field for field by ops/train_kernels.TrainArgs (ctypes).
struct TrainArgs {
  int n_inst, batch, feats, h1, h2, n_types, max_rows;
  int tied, variational, bf16_moments, decay;
  int panel[MAX_PRODUCTS]; // each product's panel width, in launch order
  int tile_tx[NSLOT];      // each weight slot's update tile threads across
  int n_items, n_weight_items;   // the update's work list
  int upd_ring[NSLOT];     // each weight slot's W, m, v through the ring
  int upd_depth, upd_lfloats, upd_rfloats, upd_rbufs, upd_stage;  // UpdArgs
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
  const int* items;        // (n_items, 4) slot, instance, row 0, column 0
  void* upd_desc;          // UPD_SLOTS x 128 bytes of device scratch
  float* param[NSLOT];     // slot -> (N, rows, cols) or (N, cols), or null
  void* m[NSLOT];          // Adam first moments, f32 or bf16, like param
  void* v[NSLOT];          // Adam second moments
  float* ws[NBUF];         // workspace, Buf order
};
}

namespace {

using namespace train;

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

// An empty kernel at the probe's launch shape: its time on the device is
// the floor that one launch costs, the bound of the probe's tiny work.
__global__ void empty_kernel() {}

// ------------------------------------------------------------- the host loop
struct Runner {
  const TrainArgs& a;
  Launcher L;

  // The update's tensors by slot: each weight with its product pair(s)
  // (layer input, gradient at the output) and L2 factor, each bias with
  // its gradient.
  void update_tensors(UpdTensor* T) const {
    const int F = a.feats, H1 = a.h1, H2 = a.h2;
    const int z2 = a.variational ? Z2 : MU;
    auto weight = [&](int slot, int R, int C, int l, int r, int l2, int r2,
                      float pen) {
      T[slot] = UpdTensor{R, C, a.tile_tx[slot], a.upd_ring[slot], pen,
                          a.ws[l], a.ws[r], l2 < 0 ? nullptr : a.ws[l2],
                          r2 < 0 ? nullptr : a.ws[r2], a.param[slot],
                          a.m[slot], a.v[slot]};
    };
    auto bias = [&](int slot, int C, int g) {
      T[slot] = UpdTensor{0, C, 0, 0, 0.f, nullptr, a.ws[g], nullptr,
                          nullptr, a.param[slot], a.m[slot], a.v[slot]};
    };
    // a tied weight also takes its decode product, transposed
    if (a.tied) {
      weight(W1, F, H1, XN, G1, G4, A3D, 2.f);
      weight(W2, H1, H2, A1D, GZ, G3, z2, 2.f);
    } else {
      weight(W1, F, H1, XN, G1, -1, -1, 1.f);
      weight(W2, H1, H2, A1D, GZ, -1, -1, 1.f);
      weight(W3, H2, H1, z2, G3, -1, -1, 1.f);
      weight(W4, H1, F, A3D, G4, -1, -1, 1.f);
    }
    if (a.variational) weight(WV, H1, H2, A1D, GLV, -1, -1, 1.f);
    bias(B1, H1, G1);
    bias(B2, H2, GZ);
    bias(B3, H1, G3);
    bias(B4, F, G4);
    if (a.variational) bias(BV, H2, GLV);
  }

  template <typename MT>
  cudaError_t step(int t) {
    const int F = a.feats, H1 = a.h1, H2 = a.h2;
    const bool tied = a.tied, vae = a.variational;
    const Mat none{nullptr, 0, 0, 0};
    const AdamStep st{t, a.decay, a.decay_steps, a.decay_rate, 1e-16f};
    cudaStream_t s = L.s;
    int product = 0;   // the step's next product, into a.panel
    auto act = [&](int buf, int width) { return L.act(a.ws[buf], width); };
    auto w = [&](int slot, int rows, int cols, bool transposed) {
      return Launcher::w_mat(a.param[slot], rows, cols, transposed);
    };
    EpiArgs e{};
    e.seeds = a.seeds; e.act = a.act; e.keep = a.keep; e.step = t;

    sample_corrupt_kernel<<<dim3(a.batch, a.n_inst), 128, 0, s>>>(a, t);
    TRAIN_TRY(L.mark(P_SAMPLE));

    // forward: z1 = xn W1 + b1 -> a1d, gf1
    e.bias = a.param[B1]; e.out0 = a.ws[A1D]; e.out1 = a.ws[GF1];
    e.purpose = philox::DROP1;
    TRAIN_TRY(L.gemm_batch<E_ACT_DROP>(P_FWD, a.panel[product++], H1, F,
                                       act(XN, F), w(W1, F, H1, false), 0,
                                       none, none, e));
    if (vae) {   // lv = a1d Wv + bv
      e.bias = a.param[BV]; e.out0 = a.ws[LV];
      TRAIN_TRY(L.gemm_batch<E_BIAS>(P_FWD, a.panel[product++], H2, H1,
                                     act(A1D, H1), w(WV, H1, H2, false), 0,
                                     none, none, e));
    }
    // mu = a1d W2 + b2
    e.bias = a.param[B2]; e.out0 = a.ws[MU];
    TRAIN_TRY(L.gemm_batch<E_BIAS>(P_FWD, a.panel[product++], H2, H1,
                                   act(A1D, H1), w(W2, H1, H2, false), 0,
                                   none, none, e));
    if (vae) {
      vae_sample_kernel<<<264, 256, 0, s>>>(a, t);
      TRAIN_TRY(L.mark(P_VAE));
    }
    const int z2 = vae ? Z2 : MU;
    // z3 = z2 W3 + b3 -> a3d, gf3 (W3 = W2^T when tied)
    e.bias = a.param[B3]; e.out0 = a.ws[A3D]; e.out1 = a.ws[GF3];
    e.purpose = philox::DROP3;
    TRAIN_TRY(L.gemm_batch<E_ACT_DROP>(
        P_FWD, a.panel[product++], H1, H2, act(z2, H2),
        tied ? w(W2, H1, H2, true) : w(W3, H2, H1, false), 0, none, none,
        e));
    // g4 = sigmoid(a3d W4 + b4) - x (W4 = W1^T when tied)
    e.bias = a.param[B4]; e.aux = a.ws[X]; e.out0 = a.ws[G4];
    TRAIN_TRY(L.gemm_batch<E_LOGIT_GRAD>(
        P_FWD, a.panel[product++], F, H1, act(A3D, H1),
        tied ? w(W1, F, H1, true) : w(W4, H1, F, false), 0, none, none, e));

    // backward: g3 = (g4 W4^T) * gf3
    e.aux = a.ws[GF3]; e.out0 = a.ws[G3];
    TRAIN_TRY(L.gemm_batch<E_MUL>(
        P_BWD, a.panel[product++], H1, F, act(G4, F),
        tied ? w(W1, F, H1, false) : w(W4, H1, F, true), 0, none, none, e));
    // gz = g3 W3^T
    e.out0 = a.ws[GZ];
    TRAIN_TRY(L.gemm_batch<E_NONE>(
        P_BWD, a.panel[product++], H2, H1, act(G3, H1),
        tied ? w(W2, H1, H2, false) : w(W3, H2, H1, true), 0, none, none,
        e));
    if (vae) {
      vae_grad_kernel<<<264, 256, 0, s>>>(a);
      TRAIN_TRY(L.mark(P_VAE));
    }
    // g1 = (gz W2^T [+ glv Wv^T]) * gf1
    e.aux = a.ws[GF1]; e.out0 = a.ws[G1];
    TRAIN_TRY(L.gemm_batch<E_MUL>(P_BWD, a.panel[product++], H1, H2,
                                  act(GZ, H2), w(W2, H1, H2, true),
                                  vae ? H2 : 0, vae ? act(GLV, H2) : none,
                                  vae ? w(WV, H1, H2, true) : none, e));

    // every weight and bias update, in one launch over the work list
    const UpdArgs u{static_cast<const UpdTensor*>(a.upd_desc),
                    reinterpret_cast<const int4*>(a.items), a.n_items,
                    a.n_weight_items, a.batch, a.upd_depth, a.upd_lfloats,
                    a.upd_rfloats, a.upd_rbufs, a.upd_stage, a.lr, a.wpen,
                    st};
    return L.update_group<MT>(P_WADAM, u);
  }
};

}  // namespace

extern "C" {

// Steps [first_step, first_step + num_steps) of the bucket described by
// ``a``, on ``stream``.  Adds the launches it made to ``*launches``.  With
// ``prof_ms`` (NPROF floats) it also times every launch with CUDA events,
// synchronising once a step, and adds each launch type's milliseconds,
// and with ``launch_ms`` too (MAX_EVENTS floats) each launch's, in order.
// Returns the first CUDA error (0 on success).
int mmae_train_run(const TrainArgs* a, int first_step, int num_steps,
                   long long* launches, float* prof_ms, float* launch_ms,
                   void* stream) {
  if (a->n_inst <= 0 || num_steps <= 0) return 0;
  if (a->n_inst > 65535 || a->batch <= 0 || a->batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (!a->tied && (!a->param[W3] || !a->param[W4]))
    return (int)cudaErrorInvalidValue;
  if (a->variational && (!a->param[WV] || !a->param[BV]))
    return (int)cudaErrorInvalidValue;
  if (!a->items || !a->upd_desc || a->n_weight_items <= 0
      || a->n_weight_items > a->n_items)
    return (int)cudaErrorInvalidValue;
  for (int b = 0; b < NBUF; ++b)
    if (!a->ws[b]) return (int)cudaErrorInvalidValue;
  Runner r{*a, Launcher{a->n_inst, a->batch,
                        static_cast<cudaStream_t>(stream), launches,
                        prof_ms}};
  r.L.per_launch = launch_ms;
  UpdTensor desc[UPD_SLOTS] = {};
  r.update_tensors(desc);
  if (!upd_ring_fits(desc, UPD_SLOTS, a->batch, a->upd_depth,
                     a->upd_lfloats, a->upd_rfloats, a->upd_rbufs,
                     a->upd_stage,
                     a->bf16_moments ? 2 : 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyAsync(a->upd_desc, desc, sizeof(desc),
                                    cudaMemcpyHostToDevice, r.L.s);
  if (err == cudaSuccess) err = r.L.create_events();
  for (int t = first_step; err == cudaSuccess && t < first_step + num_steps;
       ++t) {
    r.L.begin_step();
    err = a->bf16_moments ? r.step<__nv_bfloat16>(t) : r.step<float>(t);
    if (err == cudaSuccess) err = r.L.end_step();
  }
  r.L.destroy_events();
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

int empty_launch(void* stream) {
  empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* train_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
