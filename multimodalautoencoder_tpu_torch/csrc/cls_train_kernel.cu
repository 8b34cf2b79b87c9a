// The phase-2 classification run of a whole two-phase bucket, for sm_90a.
//
// Replaces the Pallas TPU kernel multimodalautoencoder_tpu/ops/
// train_kernel.py::_cls_train_kernel (:1439-1725, driven by _phase2_body,
// pallas_call :2044), which trained one (config, fold) instance's encoder
// and fresh classification head for S steps inside one grid cell, with
// parameters and Adam moments resident in VMEM.  As for the phase-1 kernel
// (csrc/train_kernel.cu), one instance does not fit an SM, so:
//
// - every instance's parameters (W1, b1, W2, b2, [Wv, bv], head C_j, cb_j)
//   and Adam moments live in device memory, stacked (N, rows, cols), and
//   are updated in place; the decoder does not take part (its gradient is
//   zero, so Adam leaves it as it is);
// - each step is a fixed sequence of launches over all N instances:
//     1. sample + corrupt -> xn (N, B, F) and the rows' labels y (N, B, L);
//     2. encoder products with activation + dropout in the epilogue
//        (the HEAD's keep probability drives the encoder's dropout too,
//        :1587), the VAE sample emb = mu + eps * exp(lv);
//     3. head products, each gated by _cls_gates (activation + dropout,
//        own Philox stream per layer), logits last;
//     4. the loss gradient: (sigmoid - y) / (B L) for sigmoid-CE,
//        (softmax - onehot) / B for softmax, times the last layer's gate;
//     5. backward data products down the head and the encoder (no KL);
//     6. one grouped update (update_group_kernel) over a work list: weight
//        gradient + Adam for every weight (L2 on the head's weights only,
//        :1645) and bias gradient + Adam, rsqrt Adam at a constant lr;
//   6 + 2 n_cls launches a step (12 for the validation bucket's head of
//   3 layers), 3 more for a VAE;
// - the S-step loop runs in C (mmae_cls_train_run), one call per run.
//   Each product's panel and thread tile and the update's work list come
//   from the host (ops/cls_train_kernels.cls_product_plan,
//   cls_update_work_list), once a run.
//
// The blocks, Adam and launcher are shared with the other training
// kernels (train_common.cuh): at phase 2's batch of 100 the products run
// on gemm_tile_kernel (8 x 8 register tiles), at a batch of at most 24 on
// gemm_batch_kernel.  Every sum keeps the order of the first CUDA-core
// product and update kernels, so every parameter and moment is bit for
// bit theirs (chip_smoke.py --cls-ab).  With bf16 operands every product operand, the
// backward cotangents of the weight-gradient products included, is
// rounded to bf16 and sums stay f32 (:1470-1477).  Random numbers come
// from Philox4x32-10 with phase 2's own purposes; the plain PyTorch twin
// (ops/cls_train_kernels.train_cls_kernel_reference) draws the same bits.
//
// What bounds it on an H100 (the validation bucket: tied 1000 -> 100, head
// 50 -> 20 -> 3, B = 100, N = 80): about 4.6e8 FLOP per instance and step,
// nearly all in the 100 x 1000 x 1000 forward product and the W1 gradient,
// against about 16 B of parameter and moment traffic per parameter (1.1 M
// parameters) with bf16 moments: f32 CUDA-core operations bound it
// (ops/cls_train_kernels.cls_step_bound computes both from the shapes;
// each launch's own bound: cls_launch_bounds).  The grouped update alone
// is near the ridge at B = 100 (16 B against 2 B = 200 FLOP an element):
// it takes the update's in-place path, each item's W, m and v read into
// registers at its start and in flight under its 100-row sums; at a batch
// of at most 32 it streams them through the update's shared-memory ring
// by bulk copies (train_common.cuh).

// bf16 operands (bf16_ops) take their own instantiations of the shared
// blocks
#define TRAIN_BF16_OPERANDS 1
#include "train_common.cuh"

namespace {

// Parameter slots, in the Pallas kernel's argument order.
enum Slot { W1 = 0, B1, W2, B2, WV, BV, C1, CB1, C2, CB2, C3, CB3, NSLOT };
// Workspace buffers (N, B, width): H1..H3 are the head layers' outputs
// (H3 of the last layer = logits), GFH* their gate factors d * act'(z),
// GC* the gradients at their pre-activations.
enum Buf { XN = 0, Y, A1D, GF1, MU, LV, EPS, EMB, H1B, H2B, H3B, GFH1,
           GFH2, GFH3, GC1, GC2, GC3, GEMB, GLV, G1, NBUF };
// Launch types, for the profile of one step (the grouped update is
// P_WADAM).
enum Prof { P_SAMPLE = 0, P_FWD, P_ELEM, P_BWD, P_WADAM, P_BADAM, NPROF };
constexpr int MAX_PRODUCTS = 12;   // a step's products at most

}  // namespace

extern "C" {
// Mirrored field for field by ops/cls_train_kernels.ClsArgs (ctypes).
struct ClsArgs {
  int n_inst, batch, feats, h1, h2, n_labels, n_types, max_rows;
  int n_cls;               // head layers, 1..3
  int dims[4];             // head widths: dims[0] = H2 ... dims[n_cls] = L
  int gates[3];            // activation + dropout on head layer j
  int variational, softmax, bf16_moments, bf16_ops;
  int panel[MAX_PRODUCTS];     // each product's panel width, in launch order
  int tile_cols[MAX_PRODUCTS]; // each product's thread columns (tile kernel)
  int tile_tx[NSLOT];      // each weight slot's update tile threads across
  int n_items, n_weight_items;   // the update's work list
  int upd_ring[NSLOT];     // each weight slot's W, m, v through the ring
  int upd_depth, upd_lfloats, upd_rfloats, upd_rbufs, upd_stage;  // UpdArgs
  float elem_p, mask_value, adam_eps;
  const int* seeds;        // (N,) instance seeds, >= 0
  const int* fold;         // (N,)
  const int* n_valid;      // (N,) train rows of the instance's fold
  const float* lr;         // (N,) constant phase-2 learning rate
  const float* keep;       // (N,) the head's keep probability
  const float* wpen;       // (N,) L2 penalty of the head's weights
  const int* eact;         // (N,) encoder activation id
  const int* cact;         // (N,) head activation id
  const float* train;      // (K, max_rows, F) fold train rows
  const float* labels;     // (K, max_rows, L) their labels (one-hot if ints)
  const float* type_table; // (T, F) 1 where a modality set masks a feature
  const float* cum;        // (T,) cumulative modality-set probabilities
  const int* items;        // (n_items, 4) slot, instance, row 0, column 0
  void* upd_desc;          // UPD_SLOTS x 128 bytes of device scratch
  float* param[NSLOT];     // slot -> (N, rows, cols) or (N, cols); null if absent
  void* m[NSLOT];          // Adam first moments, f32 or bf16, like param
  void* v[NSLOT];          // Adam second moments
  float* ws[NBUF];         // workspace, Buf order
};
}

namespace {

using namespace train;

// ---------------------------------------------------------------- sample
// grid (B, N): one block per batch row.  Row uniform with replacement in
// [0, n_valid), its labels from the same row (:1541-1563); element zeros
// at elem_p, then the modality set's span written with mask_value
// (:1567-1580).
__global__ void cls_sample_kernel(ClsArgs a, int step) {
  const int b = blockIdx.x, n = blockIdx.y;
  const uint32_t seed = (uint32_t)a.seeds[n];
  __shared__ int s_row, s_type;
  if (threadIdx.x == 0) {
    s_row = philox::index_below(
        philox::bits(seed, philox::CLS_ROW, step, b, 0),
        (uint32_t)a.n_valid[n]);
    const float u = philox::uniform(
        philox::bits(seed, philox::CLS_TYPE, step, b, 0));
    int t = 0;
    for (int j = 0; j < a.n_types; ++j) t += (u >= a.cum[j]) ? 1 : 0;
    s_type = t;
  }
  __syncthreads();
  const int F = a.feats, L = a.n_labels;
  const int64_t r = (int64_t)a.fold[n] * a.max_rows + s_row;
  const float* src = a.train + r * F;
  const int64_t o = ((int64_t)n * a.batch + b) * F;
  const float* mask = s_type < a.n_types ? a.type_table + (int64_t)s_type * F
                                         : nullptr;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float w = src[f];
    if (a.elem_p > 0.f &&
        philox::uniform(philox::bits(seed, philox::CLS_ELEM, step, b, f))
            < a.elem_p)
      w = 0.f;
    if (mask && mask[f] > 0.f) w = a.mask_value;
    a.ws[XN][o + f] = w;
  }
  const int64_t oy = ((int64_t)n * a.batch + b) * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x)
    a.ws[Y][oy + l] = a.labels[r * L + l];
}

// ------------------------------------------------------- elementwise
// emb = mu + eps * exp(lv), eps by Box-Muller (:1590-1596).
__global__ void cls_vae_sample_kernel(ClsArgs a, int step) {
  const int64_t total = (int64_t)a.n_inst * a.batch * a.h2;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % a.h2);
    const int b = (int)((i / a.h2) % a.batch);
    const int n = (int)(i / ((int64_t)a.h2 * a.batch));
    const float eps = philox::normal((uint32_t)a.seeds[n], philox::CLS_EPS,
                                     step, b, j);
    a.ws[EPS][i] = eps;
    a.ws[EMB][i] = a.ws[MU][i] + eps * expf(a.ws[LV][i]);
  }
}

// The embedding's gradient reaches lv through the sample only (phase 2
// has no KL term): glv = gemb * eps * exp(lv).
__global__ void cls_vae_grad_kernel(ClsArgs a) {
  const int64_t total = (int64_t)a.n_inst * a.batch * a.h2;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x)
    a.ws[GLV][i] = a.ws[GEMB][i] * a.ws[EPS][i] * expf(a.ws[LV][i]);
}

// One thread per (instance, row): the loss gradient at the logits,
// (sigmoid(z) - y) / (B L) or (softmax(z) - y) / B (:1618-1628), times the
// last head layer's gate factor when that layer is gated.
__global__ void cls_loss_grad_kernel(ClsArgs a, const float* logits,
                                     const float* gate, float* g) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x, n = blockIdx.y;
  if (b >= a.batch) return;
  const int L = a.n_labels;
  const int64_t o = ((int64_t)n * a.batch + b) * L;
  const float* z = logits + o;
  const float* y = a.ws[Y] + o;
  if (a.softmax) {
    float mx = z[0];
    for (int l = 1; l < L; ++l) mx = fmaxf(mx, z[l]);
    float sum = 0.f;
    for (int l = 0; l < L; ++l) sum += expf(z[l] - mx);
    const float inv_b = 1.f / (float)a.batch;
    for (int l = 0; l < L; ++l) {
      const float p = expf(z[l] - mx) / sum;
      const float gl = (p - y[l]) * inv_b;
      g[o + l] = gate ? gl * gate[o + l] : gl;
    }
  } else {
    const float scale = 1.f / ((float)a.batch * (float)L);
    for (int l = 0; l < L; ++l) {
      const float gl = (1.f / (1.f + expf(-z[l])) - y[l]) * scale;
      g[o + l] = gate ? gl * gate[o + l] : gl;
    }
  }
}

// ------------------------------------------------------------- the host loop
struct ClsRunner {
  const ClsArgs& a;
  Launcher L;
  int product = 0;   // the step's next product, into a.panel

  Mat act_mat(int buf, int width) const { return L.act(a.ws[buf], width); }
  Mat w_mat(int slot, int rows, int cols, bool transposed) const {
    return Launcher::w_mat(a.param[slot], rows, cols, transposed);
  }

  // The next product of the step on its planned block: gemm_batch_kernel
  // at a batch of at most BR, else gemm_tile_kernel.
  template <int EPI>
  cudaError_t gemm(int type, int ncol, int K, Mat A, Mat B, int K2, Mat A2,
                   Mat B2, const EpiArgs& e) {
    if (product >= MAX_PRODUCTS) return cudaErrorInvalidValue;
    const int pw = a.panel[product], tc = a.tile_cols[product];
    ++product;
    if (a.batch <= BR)
      return L.gemm_batch<EPI>(type, pw, ncol, K, A, B, K2, A2, B2, e);
    return L.gemm_tile<EPI>(type, pw, tc, ncol, K, A, B, K2, A2, B2, e);
  }

  // The update's tensors by slot: each weight with its product pair (layer
  // input, gradient at the output) and L2 factor (0 on the encoder, 1 on
  // the head), each bias with its gradient.
  void update_tensors(UpdTensor* T) const {
    const int nc = a.n_cls;
    auto weight = [&](int slot, int R, int C, int l, int r, float pen) {
      T[slot] = UpdTensor{R, C, a.tile_tx[slot], a.upd_ring[slot], pen,
                          a.ws[l], a.ws[r], nullptr, nullptr, a.param[slot],
                          a.m[slot], a.v[slot]};
    };
    auto bias = [&](int slot, int C, int g) {
      T[slot] = UpdTensor{0, C, 0, 0, 0.f, nullptr, a.ws[g], nullptr,
                          nullptr, a.param[slot], a.m[slot], a.v[slot]};
    };
    const int emb = a.variational ? EMB : MU;
    const int hb[4] = {emb, H1B, H2B, H3B};
    const int gcb[4] = {-1, GC1, GC2, GC3};
    weight(W1, a.feats, a.h1, XN, G1, 0.f);
    weight(W2, a.h1, a.h2, A1D, GEMB, 0.f);
    bias(B1, a.h1, G1);
    bias(B2, a.h2, GEMB);
    if (a.variational) {
      weight(WV, a.h1, a.h2, A1D, GLV, 0.f);
      bias(BV, a.h2, GLV);
    }
    for (int j = 0; j < nc; ++j) {
      weight(C1 + 2 * j, a.dims[j], a.dims[j + 1], hb[j], gcb[j + 1], 1.f);
      bias(CB1 + 2 * j, a.dims[j + 1], gcb[j + 1]);
    }
  }

  template <typename MT>
  cudaError_t step(int t) {
    const int F = a.feats, H1 = a.h1, H2 = a.h2, nc = a.n_cls;
    const bool vae = a.variational;
    const Mat none{nullptr, 0, 0, 0};
    const AdamStep st{t, 0, 1.f, 1.f, a.adam_eps * a.adam_eps};
    cudaStream_t s = L.s;
    product = 0;
    EpiArgs e{};
    e.seeds = a.seeds; e.keep = a.keep; e.step = t; e.bf16 = a.bf16_ops;

    cls_sample_kernel<<<dim3(a.batch, a.n_inst), 128, 0, s>>>(a, t);
    TRAIN_TRY(L.mark(P_SAMPLE));

    // encoder: z1 = xn W1 + b1 -> a1d, gf1; mu = a1d W2 + b2
    e.act = a.eact; e.purpose = philox::CLS_DROP1;
    e.bias = a.param[B1]; e.out0 = a.ws[A1D]; e.out1 = a.ws[GF1];
    TRAIN_TRY(gemm<E_ACT_DROP>(P_FWD, H1, F, act_mat(XN, F),
                                 w_mat(W1, F, H1, false), 0, none, none, e));
    e.bias = a.param[B2]; e.out0 = a.ws[MU];
    TRAIN_TRY(gemm<E_BIAS>(P_FWD, H2, H1, act_mat(A1D, H1),
                             w_mat(W2, H1, H2, false), 0, none, none, e));
    if (vae) {
      e.bias = a.param[BV]; e.out0 = a.ws[LV];
      TRAIN_TRY(gemm<E_BIAS>(P_FWD, H2, H1, act_mat(A1D, H1),
                               w_mat(WV, H1, H2, false), 0, none, none, e));
      cls_vae_sample_kernel<<<264, 256, 0, s>>>(a, t);
      TRAIN_TRY(L.mark(P_ELEM));
    }
    const int emb = vae ? EMB : MU;

    // head: h_{j+1} = gate_j(h_j C_j + cb_j)
    const int hb[4] = {emb, H1B, H2B, H3B};
    const int gfb[4] = {-1, GFH1, GFH2, GFH3};
    const int gcb[4] = {-1, GC1, GC2, GC3};
    e.act = a.cact;
    for (int j = 0; j < nc; ++j) {
      const int din = a.dims[j], dout = a.dims[j + 1];
      e.bias = a.param[CB1 + 2 * j]; e.out0 = a.ws[hb[j + 1]];
      const Mat A = act_mat(hb[j], din);
      const Mat W = w_mat(C1 + 2 * j, din, dout, false);
      if (a.gates[j]) {
        e.out1 = a.ws[gfb[j + 1]];
        e.purpose = philox::CLS_HEAD_DROP + j;
        TRAIN_TRY(gemm<E_ACT_DROP>(P_FWD, dout, din, A, W, 0, none, none,
                                     e));
      } else {
        TRAIN_TRY(gemm<E_BIAS>(P_FWD, dout, din, A, W, 0, none, none, e));
      }
    }

    // loss gradient at the last layer's pre-activation
    {
      const dim3 grid((a.batch + 127) / 128, a.n_inst);
      cls_loss_grad_kernel<<<grid, 128, 0, s>>>(
          a, a.ws[hb[nc]], a.gates[nc - 1] ? a.ws[gfb[nc]] : nullptr,
          a.ws[gcb[nc]]);
      TRAIN_TRY(L.mark(P_ELEM));
    }

    // backward down the head (weights read before any update):
    // g_j = (g_{j+1} C_j^T) [* gate factor of layer j - 1]; gemb last
    for (int j = nc - 1; j >= 0; --j) {
      const int din = a.dims[j], dout = a.dims[j + 1];
      const Mat A = act_mat(gcb[j + 1], dout);
      const Mat Wt = w_mat(C1 + 2 * j, din, dout, true);
      if (j == 0) {
        e.out0 = a.ws[GEMB];
        TRAIN_TRY(gemm<E_NONE>(P_BWD, din, dout, A, Wt, 0, none, none, e));
      } else if (a.gates[j - 1]) {
        e.aux = a.ws[gfb[j]]; e.out0 = a.ws[gcb[j]];
        TRAIN_TRY(gemm<E_MUL>(P_BWD, din, dout, A, Wt, 0, none, none, e));
      } else {
        e.out0 = a.ws[gcb[j]];
        TRAIN_TRY(gemm<E_NONE>(P_BWD, din, dout, A, Wt, 0, none, none, e));
      }
    }
    if (vae) {
      cls_vae_grad_kernel<<<264, 256, 0, s>>>(a);
      TRAIN_TRY(L.mark(P_ELEM));
    }
    // g1 = (gemb W2^T [+ glv Wv^T]) * gf1
    e.aux = a.ws[GF1]; e.out0 = a.ws[G1];
    TRAIN_TRY(gemm<E_MUL>(P_BWD, H1, H2, act_mat(GEMB, H2),
                            w_mat(W2, H1, H2, true), vae ? H2 : 0,
                            vae ? act_mat(GLV, H2) : none,
                            vae ? w_mat(WV, H1, H2, true) : none, e));

    // every weight and bias update (L2 on the head's weights only), in
    // one launch over the work list
    const UpdArgs u{static_cast<const UpdTensor*>(a.upd_desc),
                    reinterpret_cast<const int4*>(a.items), a.n_items,
                    a.n_weight_items, a.batch, a.upd_depth, a.upd_lfloats,
                    a.upd_rfloats, a.upd_rbufs, a.upd_stage, a.lr, a.wpen,
                    st};
    TRAIN_TRY(L.update_group<MT>(P_WADAM, u, a.bf16_ops));
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// Steps [first_step, first_step + num_steps) of the phase-2 bucket
// described by ``a``, on ``stream``.  Adds the launches it made to
// ``*launches``.  With ``prof_ms`` (NPROF floats) it also times every
// launch with CUDA events, synchronising once a step, and adds each launch
// type's milliseconds, and with ``launch_ms`` too (MAX_EVENTS floats) each
// launch's, in order.  Returns the first CUDA error (0 on success).
int mmae_cls_train_run(const ClsArgs* a, int first_step, int num_steps,
                       long long* launches, float* prof_ms, float* launch_ms,
                       void* stream) {
  if (a->n_inst <= 0 || num_steps <= 0) return 0;
  if (a->n_inst > 65535 || a->batch <= 0 || a->batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (a->n_cls < 1 || a->n_cls > 3 || a->dims[0] != a->h2
      || a->dims[a->n_cls] != a->n_labels || a->n_labels < 1)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < a->n_cls; ++j)
    if (!a->param[C1 + 2 * j] || !a->param[CB1 + 2 * j])
      return (int)cudaErrorInvalidValue;
  if (a->variational && (!a->param[WV] || !a->param[BV]))
    return (int)cudaErrorInvalidValue;
  if (!a->items || !a->upd_desc || a->n_weight_items <= 0
      || a->n_weight_items > a->n_items)
    return (int)cudaErrorInvalidValue;
  ClsRunner r{*a, Launcher{a->n_inst, a->batch,
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

const char* cls_train_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
