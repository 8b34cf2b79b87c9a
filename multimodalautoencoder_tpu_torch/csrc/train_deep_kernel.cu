// The depth >= 3 DAE/VAE training run of a whole shape bucket, for sm_90a.
//
// Replaces the Pallas TPU kernel multimodalautoencoder_tpu/ops/
// train_kernel.py::_train_kernel_deep (:589-843, driven by _pipeline_deep,
// pallas_call :1279): the depth-2 kernel's math (csrc/train_kernel.cu)
// unrolled over L encode and L decode layers, one (config, fold) instance
// per grid cell with its parameters and Adam moments resident in VMEM.  As
// for depth 2, one instance does not fit an SM here (tied 1000 -> 500 ->
// 100 is 6.2 MB of f32 weights), so:
//
// - every instance's parameters and Adam moments live in device memory,
//   stacked (N, rows, cols), in slots encW(L), decW(L, untied only),
//   encB(L), decB(L), wv, bv, and are updated in place;
// - each step is a fixed sequence of 4L + 1 launches (4L + 4 for a VAE)
//   over all N instances, from train_common.cuh's blocks:
//     1. sample + corrupt -> x, xn (the depth-2 draws, :669-705);
//     2. L encode and L decode products (gemm_batch_kernel) with bias,
//        activation and dropout in the epilogue on every layer except the
//        linear embedding and the logits (:714-759), each hidden layer
//        keeping its dropped activation and d * act'(z); a VAE takes its
//        log-sigma head off the last hidden activation (:720-724) and
//        samples z = mu + eps * exp(lv) (:731-736); the logit gradient
//        sigmoid(y) - x is the last decode product's epilogue;
//     3. the backward chain against W^T with d * act'(z) in the epilogue:
//        down the decoder to gz, the KL terms on the sampled z, down the
//        encoder with the wv term added into layer L-2 (:762-789);
//     4. one grouped update (update_group_kernel) over a work list: weight
//        gradient + L2 + rsqrt Adam per weight, a tied weight summing its
//        encode product and its decode product transposed, with the L2
//        doubled (:804-814), wv's L2 undoubled (:821-828), then bias
//        gradient + Adam; Adam's scalars with smooth decay (:791-800);
// - the S-step loop runs in C (mmae_deep_train_run), one call per run.
//   Each product's panel width and the update's work list come from the
//   host (ops/train_deep_kernels.product_plan, update_work_list), once a
//   run.
//
// Widths are not padded here, so the Pallas kernel's _mask_cols (which
// zeroes the lane padding of activations and eps) has no counterpart: no
// padded column exists to leak into a real weight.
//
// What bounds it on an H100 (tied 1000 -> 500 -> 100, N = 60, B = 20,
// 1.55 M parameters an instance): each step streams W, m and v in and out,
// 16 B a parameter with bf16 moments (1.49 GB a step, 0.44 ms at 3.35
// TB/s), against about 40 FLOP per weight element; bytes bound it, as for
// depth 2 (ops/train_deep_kernels.deep_step_bound computes it; each
// launch's own bound: deep_launch_bounds).  At B = 20 the grouped update
// streams W, m and v through a shared-memory ring by bulk copies, a copy
// warp keeping the next items' in flight and writing the last ones back
// under the sums (train_common.cuh), where a register tile loaded one
// item ahead left the reads in bursts (57 % of its bound, PERF.md).  The 1000-wide products run at
// 41-53 % of theirs, as torch.bmm does; their copies alone, with no FMAs,
// reach about 60 %, and neither the tensor-map engine nor deeper rings,
// wider panels or L2 prefetches moved them.  Random
// numbers come from Philox4x32-10 with the deep purposes (philox.cuh); the
// plain PyTorch twin (ops/train_deep_kernels.train_deep_kernel_reference)
// draws the same bits.

#include "train_common.cuh"

namespace {

constexpr int MAX_DEPTH = 16;   // ops/train_kernels.MAX_DEPTH
// Parameter slots: layer i's encode weight at ENC_W + i, and so on.
enum Slot { ENC_W = 0, DEC_W = MAX_DEPTH, ENC_B = 2 * MAX_DEPTH,
            DEC_B = 3 * MAX_DEPTH, WV = 4 * MAX_DEPTH, BV, NSLOT };
static_assert(NSLOT == train::UPD_SLOTS, "the update's descriptor table");
// Workspace buffers (N, B, width): encode layer i's output (its dropped
// activation, or mu for the last), gate factor d * act'(z) and gradient at
// its pre-activation; the same for decode layer j (no stored output for
// the logits).
enum Buf { X = 0, XN, LV, EPS, Z, GLV, ENC_OUT,
           ENC_GF = ENC_OUT + MAX_DEPTH, ENC_G = ENC_GF + MAX_DEPTH,
           DEC_OUT = ENC_G + MAX_DEPTH, DEC_GF = DEC_OUT + MAX_DEPTH,
           DEC_G = DEC_GF + MAX_DEPTH, NBUF = DEC_G + MAX_DEPTH };
// Launch types, for the profile of one step (the grouped update is
// P_WADAM).
enum Prof { P_SAMPLE = 0, P_FWD, P_VAE, P_BWD, P_WADAM, P_BADAM, NPROF };
constexpr int MAX_PRODUCTS = 4 * MAX_DEPTH;   // a step's products

}  // namespace

extern "C" {
// Mirrored field for field by ops/train_deep_kernels.DeepArgs (ctypes).
struct DeepArgs {
  int n_inst, batch, depth, n_types, max_rows;
  int tied, variational, bf16_moments, decay;
  int dims[MAX_DEPTH + 1]; // F, H1, ..., HL
  int panel[MAX_PRODUCTS]; // each product's panel width, in launch order
  int tile_tx[NSLOT];      // each weight slot's update tile threads across
  int n_items, n_weight_items;   // the update's work list
  int upd_ring[NSLOT];     // each weight slot's W, m, v through the ring
  int upd_depth, upd_lfloats, upd_rfloats, upd_rbufs, upd_stage;  // UpdArgs
  float elem_p, mask_value, decay_steps, decay_rate;
  float adam_eps2;         // Adam's eps squared
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
  void* upd_desc;          // NSLOT x 128 bytes of device scratch
  float* param[NSLOT];     // slot -> (N, rows, cols) or (N, cols), or null
  void* m[NSLOT];          // Adam first moments, f32 or bf16, like param
  void* v[NSLOT];          // Adam second moments
  float* ws[NBUF];         // workspace, Buf order; null where unused
};
}

namespace {

using namespace train;

// What the sample kernel reads, passed by value.
struct SampleArgs {
  const int* seeds; const int* fold; const int* n_valid;
  const float* train; const float* type_table; const float* cum;
  int batch, feats, n_types, max_rows;
  float elem_p, mask_value;
  float* x; float* xn;
};

// grid (B, N): one block per batch row, the depth-2 kernel's draws.  The
// row is uniform with replacement in the fold's n_valid train rows; the
// modality set comes from the cumulative probabilities (t == T: nothing
// masked); element zeros at rate elem_p, then the set's span is written
// with mask_value.
__global__ void deep_sample_kernel(SampleArgs a, int step) {
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
    a.x[o + f] = v;
    a.xn[o + f] = w;
  }
}

// z = mu + eps * exp(lv) over (N, B, width), eps by Box-Muller from the
// DEEP_EPS stream (multimodal_autoencoder.py:372-375).
__global__ void deep_vae_sample_kernel(int64_t total, int batch, int width,
                                       const int* seeds, const float* mu,
                                       const float* lv, float* eps, float* z,
                                       int step) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(i % width);
    const int b = (int)((i / width) % batch);
    const int n = (int)(i / ((int64_t)width * batch));
    const float e = philox::normal((uint32_t)seeds[n], philox::DEEP_EPS,
                                   step, b, j);
    eps[i] = e;
    z[i] = mu[i] + e * expf(lv[i]);
  }
}

// KL on the sampled z (reference :402-406): gz += z / B,
// glv = gz * eps * sigma + (e^{2 lv} - 1) / B.
__global__ void deep_vae_grad_kernel(int64_t total, int batch,
                                     const float* lv, const float* z,
                                     const float* eps, float* gz,
                                     float* glv) {
  const float inv_b = 1.f / (float)batch;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float l = lv[i];
    const float g = gz[i] + z[i] * inv_b;
    gz[i] = g;
    glv[i] = g * eps[i] * expf(l) + (expf(2.f * l) - 1.f) * inv_b;
  }
}

// ------------------------------------------------------------- the host loop
struct DeepRunner {
  const DeepArgs& a;
  Launcher L;
  int product = 0;   // the step's next product, into a.panel

  Mat act_mat(int buf, int width) const { return L.act(a.ws[buf], width); }
  // encode weight i, (d[i] x d[i+1]), or its transpose
  Mat enc_w(int i, bool transposed) const {
    return Launcher::w_mat(a.param[ENC_W + i], a.dims[i], a.dims[i + 1],
                           transposed);
  }
  // decode weight j, (d[L-j] x d[L-j-1]), or its transpose; tied, the
  // transpose of encode weight L-1-j
  Mat dec_w(int j, bool transposed) const {
    const int r = a.dims[a.depth - j], c = a.dims[a.depth - j - 1];
    if (a.tied)
      return Launcher::w_mat(a.param[ENC_W + a.depth - 1 - j], c, r,
                             !transposed);
    return Launcher::w_mat(a.param[DEC_W + j], r, c, transposed);
  }
  // buffers holding encode layer i's input and decode layer j's input
  int enc_in(int i) const { return i == 0 ? XN : ENC_OUT + i - 1; }
  int dec_in(int j) const {
    return j > 0 ? DEC_OUT + j - 1
                 : (a.variational ? Z : ENC_OUT + a.depth - 1);
  }

  template <int EPI>
  cudaError_t gemm(int type, int ncol, int K, Mat A, Mat B, int K2, Mat A2,
                   Mat B2, const EpiArgs& e) {
    if (product >= MAX_PRODUCTS) return cudaErrorInvalidValue;
    return L.gemm_batch<EPI>(type, a.panel[product++], ncol, K, A, B, K2,
                             A2, B2, e);
  }

  // The update's tensors by slot: each weight with its product pair(s)
  // (layer input, gradient at the output) and L2 factor, each bias with
  // its gradient.
  void update_tensors(UpdTensor* T) const {
    const int D = a.depth;
    const int* d = a.dims;
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
    // a tied weight also takes decode layer L-1-i's product, transposed
    for (int i = 0; i < D; ++i) {
      const int j0 = D - 1 - i;
      weight(ENC_W + i, d[i], d[i + 1], enc_in(i), ENC_G + i,
             a.tied ? DEC_G + j0 : -1, a.tied ? dec_in(j0) : -1,
             a.tied ? 2.f : 1.f);
    }
    if (!a.tied)
      for (int j = 0; j < D; ++j)
        weight(DEC_W + j, d[D - j], d[D - j - 1], dec_in(j), DEC_G + j, -1,
               -1, 1.f);
    if (a.variational)
      weight(WV, d[D - 1], d[D], enc_in(D - 1), GLV, -1, -1, 1.f);
    for (int i = 0; i < D; ++i) {
      bias(ENC_B + i, d[i + 1], ENC_G + i);
      bias(DEC_B + i, d[D - i - 1], DEC_G + i);
    }
    if (a.variational) bias(BV, d[D], GLV);
  }

  template <typename MT>
  cudaError_t step(int t) {
    const int D = a.depth;
    const int* d = a.dims;
    const bool vae = a.variational;
    const Mat none{nullptr, 0, 0, 0};
    const AdamStep st{t, a.decay, a.decay_steps, a.decay_rate,
                      a.adam_eps2};
    cudaStream_t s = L.s;
    product = 0;
    EpiArgs e{};
    e.seeds = a.seeds; e.act = a.act; e.keep = a.keep; e.step = t;

    const SampleArgs sa{a.seeds, a.fold, a.n_valid, a.train, a.type_table,
                        a.cum, a.batch, d[0], a.n_types, a.max_rows,
                        a.elem_p, a.mask_value, a.ws[X], a.ws[XN]};
    deep_sample_kernel<<<dim3(a.batch, a.n_inst), 128, 0, s>>>(sa, t);
    TRAIN_TRY(L.mark(P_SAMPLE));

    // forward, encoder: layer i (d[i] -> d[i+1]), dropout stream
    // DEEP_DROP + i; the last layer is the linear embedding mu
    for (int i = 0; i < D; ++i) {
      const Mat A = act_mat(enc_in(i), d[i]);
      if (vae && i == D - 1) {
        e.bias = a.param[BV]; e.out0 = a.ws[LV];
        TRAIN_TRY(gemm<E_BIAS>(
            P_FWD, d[D], d[D - 1], A,
            Launcher::w_mat(a.param[WV], d[D - 1], d[D], false), 0, none,
            none, e));
      }
      e.bias = a.param[ENC_B + i]; e.out0 = a.ws[ENC_OUT + i];
      if (i < D - 1) {
        e.out1 = a.ws[ENC_GF + i];
        e.purpose = philox::DEEP_DROP + i;
        TRAIN_TRY(gemm<E_ACT_DROP>(P_FWD, d[i + 1], d[i], A, enc_w(i, false),
                                   0, none, none, e));
      } else {
        TRAIN_TRY(gemm<E_BIAS>(P_FWD, d[i + 1], d[i], A, enc_w(i, false),
                               0, none, none, e));
      }
    }
    const int64_t n_emb = (int64_t)a.n_inst * a.batch * d[D];
    if (vae) {
      deep_vae_sample_kernel<<<264, 256, 0, s>>>(
          n_emb, a.batch, d[D], a.seeds, a.ws[ENC_OUT + D - 1], a.ws[LV],
          a.ws[EPS], a.ws[Z], t);
      TRAIN_TRY(L.mark(P_VAE));
    }
    // forward, decoder: layer j (d[D-j] -> d[D-j-1]), dropout stream
    // DEEP_DROP + D + j; the last product's epilogue is sigmoid(y) - x
    for (int j = 0; j < D; ++j) {
      const Mat A = act_mat(dec_in(j), d[D - j]);
      e.bias = a.param[DEC_B + j];
      if (j < D - 1) {
        e.out0 = a.ws[DEC_OUT + j]; e.out1 = a.ws[DEC_GF + j];
        e.purpose = philox::DEEP_DROP + D + j;
        TRAIN_TRY(gemm<E_ACT_DROP>(P_FWD, d[D - j - 1], d[D - j], A,
                                   dec_w(j, false), 0, none, none, e));
      } else {
        e.aux = a.ws[X]; e.out0 = a.ws[DEC_G + j];
        TRAIN_TRY(gemm<E_LOGIT_GRAD>(P_FWD, d[0], d[1], A, dec_w(j, false),
                                     0, none, none, e));
      }
    }

    // backward, decoder: g_j = (g_{j+1} W_{j+1}^T) * gf_j
    for (int j = D - 2; j >= 0; --j) {
      e.aux = a.ws[DEC_GF + j]; e.out0 = a.ws[DEC_G + j];
      TRAIN_TRY(gemm<E_MUL>(P_BWD, d[D - j - 1], d[D - j - 2],
                            act_mat(DEC_G + j + 1, d[D - j - 2]),
                            dec_w(j + 1, true), 0, none, none, e));
    }
    // gz = g_0 W_dec0^T, the embedding's gradient
    e.out0 = a.ws[ENC_G + D - 1];
    TRAIN_TRY(gemm<E_NONE>(P_BWD, d[D], d[D - 1],
                           act_mat(DEC_G, d[D - 1]), dec_w(0, true), 0,
                           none, none, e));
    if (vae) {
      deep_vae_grad_kernel<<<264, 256, 0, s>>>(
          n_emb, a.batch, a.ws[LV], a.ws[Z], a.ws[EPS], a.ws[ENC_G + D - 1],
          a.ws[GLV]);
      TRAIN_TRY(L.mark(P_VAE));
    }
    // backward, encoder: g_i = (g_{i+1} W_{i+1}^T [+ glv Wv^T at i = L-2])
    // * gf_i
    for (int i = D - 2; i >= 0; --i) {
      const bool head = vae && i == D - 2;
      e.aux = a.ws[ENC_GF + i]; e.out0 = a.ws[ENC_G + i];
      TRAIN_TRY(gemm<E_MUL>(
          P_BWD, d[i + 1], d[i + 2], act_mat(ENC_G + i + 1, d[i + 2]),
          enc_w(i + 1, true), head ? d[D] : 0,
          head ? act_mat(GLV, d[D]) : none,
          head ? Launcher::w_mat(a.param[WV], d[D - 1], d[D], true) : none,
          e));
    }

    // every weight and bias update, in one launch over the work list
    const UpdArgs u{static_cast<const UpdTensor*>(a.upd_desc),
                    reinterpret_cast<const int4*>(a.items), a.n_items,
                    a.n_weight_items, a.batch, a.upd_depth, a.upd_lfloats,
                    a.upd_rfloats, a.upd_rbufs, a.upd_stage, a.lr, a.wpen,
                    st};
    return L.update_group<MT>(P_WADAM, u);
  }
};

// Every pointer the run reads or writes is set.
bool complete(const DeepArgs* a) {
  const int D = a->depth;
  for (int i = 0; i <= D; ++i)
    if (a->dims[i] <= 0) return false;
  for (int i = 0; i < D; ++i) {
    if (!a->param[ENC_W + i] || !a->param[ENC_B + i] || !a->param[DEC_B + i]
        || (!a->tied && !a->param[DEC_W + i]) || !a->ws[ENC_OUT + i]
        || !a->ws[ENC_G + i] || !a->ws[DEC_G + i])
      return false;
    if (i < D - 1 && (!a->ws[ENC_GF + i] || !a->ws[DEC_OUT + i]
                      || !a->ws[DEC_GF + i]))
      return false;
  }
  if (!a->ws[X] || !a->ws[XN] || !a->items || !a->upd_desc
      || a->n_items <= 0 || a->n_weight_items <= 0
      || a->n_weight_items > a->n_items)
    return false;
  if (a->variational && (!a->param[WV] || !a->param[BV] || !a->ws[LV]
                         || !a->ws[EPS] || !a->ws[Z] || !a->ws[GLV]))
    return false;
  return true;
}

}  // namespace

extern "C" {

// Steps [first_step, first_step + num_steps) of the bucket described by
// ``a``, on ``stream``.  Adds the launches it made to ``*launches``.  With
// ``prof_ms`` (NPROF floats) it also times every launch with CUDA events,
// synchronising once a step, and adds each launch type's milliseconds, and
// with ``launch_ms`` too (MAX_EVENTS floats) each launch's, in order.
// Returns the first CUDA error (0 on success).
int mmae_deep_train_run(const DeepArgs* a, int first_step, int num_steps,
                        long long* launches, float* prof_ms,
                        float* launch_ms, void* stream) {
  if (a->n_inst <= 0 || num_steps <= 0) return 0;
  if (a->n_inst > 65535 || a->batch <= 0 || a->batch > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if (a->depth < 2 || a->depth > MAX_DEPTH || !complete(a))
    return (int)cudaErrorInvalidValue;
  DeepRunner r{*a, Launcher{a->n_inst, a->batch,
                            static_cast<cudaStream_t>(stream), launches,
                            prof_ms}};
  r.L.per_launch = launch_ms;
  UpdTensor desc[NSLOT] = {};
  r.update_tensors(desc);
  if (!upd_ring_fits(desc, NSLOT, a->batch, a->upd_depth,
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

const char* deep_train_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
