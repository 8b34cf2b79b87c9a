"""Per-instance-step operation and byte counts, and a utilization row
against the H100's peaks.

Counterpart of ``multimodalautoencoder_tpu/utils/flops.py``.  The
training kernels' throughput is reported in instance-steps/s (one
instance-step is one Adam step of one (config, fold) instance); these
counts turn that rate into useful FLOP/s and bytes/s.  Counts are useful
work of the unpadded model.

:func:`train_step_flops` and :func:`cls_train_step_flops` are the JAX
package's counts, copied.  The byte counts are the port's own: the H100
kernels (and the plain backend) read and write every parameter and both
Adam moments each step and read the sampled rows once
(``ops/train_kernels.step_bound``, ``ops/cls_train_kernels.
cls_step_bound``), which is the JAX package's XLA count without the TPU's
128-lane padding; its Pallas count models the TPU kernels' VMEM-resident
weights and aligned DMA panels, which the port's kernels do not have.
:func:`utilization_row` divides by the H100's published peaks.
"""

from __future__ import annotations

from typing import Dict

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig


def train_step_flops(cfg: MMAEConfig, tcfg: TrainConfig) -> Dict[str, float]:
    """FLOPs of ONE unsupervised training step of ONE (config, fold)
    instance (the Pallas kernel ``_train_kernel``'s step, and
    csrc/train_kernel.cu's): forward + backward products (``mxu``) and the
    elementwise corruption, activation and Adam work (``vpu``); the keys
    keep the JAX package's names.

    Returns {"mxu": flops, "vpu": flops, "total": flops,
    "adam_elems": per-step Adam-updated elements}.
    """
    cfg = cfg.validate()
    B = tcfg.batch_size
    F = cfg.num_feats
    H1, H2 = cfg.layer_sizes

    # ---- products: 2*m*n*k per matmul -------------------------------
    # forward: x@W1, a1@W2, z2@W3, a3@W4 (+ a1@Wv for the VAE head)
    fwd = 2 * B * (F * H1 + H1 * H2 + H2 * H1 + H1 * F)
    if cfg.variational:
        fwd += 2 * B * H1 * H2
    # backward data grads: g4@W4^T, g3@W3^T, g2@W2^T (+ glv@Wv^T)
    bwd_data = 2 * B * (F * H1 + H1 * H2 + H2 * H1)
    if cfg.variational:
        bwd_data += 2 * B * H2 * H1
    # weight grads: xn^T@g1, a1^T@g2, z2^T@g3, a3^T@g4 (+ a1^T@glv);
    # tied weights accumulate four products into two tensors — same FLOPs
    bwd_w = 2 * B * (F * H1 + H1 * H2 + H2 * H1 + H1 * F)
    if cfg.variational:
        bwd_w += 2 * B * H1 * H2
    mxu = float(fwd + bwd_data + bwd_w)

    # ---- elementwise -----------------------------------------------
    # corruption + activations + dropout + loss grad ~ O(B*F + B*H1)
    # passes; Adam: per updated element, m update (3), v update (4),
    # p update in the rsqrt form (4: add, rsqrt, 2 mul+sub fused-ish)
    w_elems = F * H1 + H1 * H2
    if not cfg.tie_weights:
        w_elems += H2 * H1 + H1 * F
    if cfg.variational:
        w_elems += H1 * H2
    b_elems = 2 * H1 + H2 + F + (H2 if cfg.variational else 0)
    adam_elems = w_elems + b_elems
    act_passes = 12.0            # measured-order estimate, not exact
    vpu = float(act_passes * B * (F + H1 + H2) + 11.0 * adam_elems)

    return {"mxu": mxu, "vpu": vpu, "total": mxu + vpu,
            "adam_elems": float(adam_elems)}


def train_step_hbm_bytes(cfg: MMAEConfig, tcfg: TrainConfig) -> float:
    """Device-memory bytes of one phase-1 instance-step of the depth-2
    family: every parameter read and written (f32), both Adam moments read
    and written (in ``tcfg``'s moment type), the sampled batch rows read
    once (``ops/train_kernels.step_bound`` for one instance)."""
    from multimodalautoencoder_tpu_torch.ops import train_kernels

    return float(train_kernels.step_bound(
        cfg, 1, tcfg.batch_size,
        tcfg.optimizer_state_dtype == "bfloat16")["bytes"])


def cls_train_step_hbm_bytes(cfg: MMAEConfig,
                             cls_tcfg: TrainConfig) -> float:
    """Device-memory bytes of one phase-2 instance-step: every trained
    parameter and both Adam moments read and written, the sampled rows
    and their labels read once (``ops/cls_train_kernels.cls_step_bound``
    for one instance)."""
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels

    return float(cls_train_kernels.cls_step_bound(
        cfg, 1, cls_tcfg.batch_size,
        cls_tcfg.optimizer_state_dtype == "bfloat16")["bytes"])


def cls_train_step_flops(cfg: MMAEConfig,
                         tcfg: TrainConfig) -> Dict[str, float]:
    """FLOPs of ONE phase-2 classification training step of ONE
    (config, fold) cell (``_cls_train_kernel``'s step, and
    csrc/cls_train_kernel.cu's): encoder forward (frozen decoder never
    runs), classifier-head forward, backward through head + encoder,
    weight grads, at the reference's classifier batch (100,
    autoencoder_classification_wrapper.py:92).  With
    ``compute_dtype='bfloat16'`` the same counts apply against the bf16
    peak.
    """
    cfg = cfg.validate()
    B = tcfg.batch_size
    F = cfg.num_feats
    H1, H2 = cfg.layer_sizes
    dims = ([H2] + list(cfg.classification_layer_sizes or ())
            + [cfg.num_labels])

    # encoder forward: x@W1, a1@W2 (+ a1@Wv for the VAE head)
    fwd = 2 * B * (F * H1 + H1 * H2)
    if cfg.variational:
        fwd += 2 * B * H1 * H2
    # head forward
    head = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    fwd += 2 * B * head
    # backward: head data+weight grads, encoder data grads
    # (g@W2^T [+ glv@Wv^T]) and weight grads (xn^T@g1, a1^T@gmu [+glv])
    bwd = 2 * B * (2 * head) + 2 * B * (H1 * H2 + F * H1 + H1 * H2)
    if cfg.variational:
        bwd += 2 * B * (2 * H1 * H2)
    mxu = float(fwd + bwd)

    # elementwise: activations/dropout/loss ~ O(B*(F+H1+H2+head widths)) passes
    # + 11 ops/Adam element (encoder w1,b1,w2,b2 [+wv,bv] + head)
    w_elems = F * H1 + H1 * H2 + head
    if cfg.variational:
        w_elems += H1 * H2
    b_elems = H1 + H2 + sum(dims[1:]) + (H2 if cfg.variational else 0)
    adam_elems = w_elems + b_elems
    act_passes = 10.0
    vpu = float(act_passes * B * (F + H1 + H2 + sum(dims[1:]))
                + 11.0 * adam_elems)
    return {"mxu": mxu, "vpu": vpu, "total": mxu + vpu,
            "adam_elems": float(adam_elems)}


# One NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): f32
# outside the tensor cores, bf16 on them, and the device-memory rate.
H100_PEAK_F32_FLOPS = 6.7e13
H100_PEAK_BF16_FLOPS = 9.89e14
H100_PEAK_HBM_BYTES = 3.35e12


def utilization_row(name: str, cfg: MMAEConfig, tcfg: TrainConfig,
                    inst_steps_per_s: float) -> Dict[str, float]:
    """One roofline row from a measured phase-1 instance-steps/s rate:
    useful FLOP/s and bytes/s, and their shares of the H100's f32 and
    memory peaks."""
    fl = train_step_flops(cfg, tcfg)
    hbm = train_step_hbm_bytes(cfg, tcfg)
    flops_s = fl["total"] * inst_steps_per_s
    hbm_s = hbm * inst_steps_per_s
    return {
        "name": name,
        "inst_steps_per_s": inst_steps_per_s,
        "useful_gflops_per_s": flops_s / 1e9,
        "pct_f32_peak": 100.0 * flops_s / H100_PEAK_F32_FLOPS,
        "hbm_gb_per_s": hbm_s / 1e9,
        "pct_hbm_peak": 100.0 * hbm_s / H100_PEAK_HBM_BYTES,
        "adam_gelems_per_s": fl["adam_elems"] * inst_steps_per_s / 1e9,
    }
