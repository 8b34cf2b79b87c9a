"""Adapter of the program entry ``parallel/grid_trainer.train_grid_sharded``
(phase 1 of the sweeps: one depth-2 MMAE bucket a call, on the training
kernels).

A traffic file that names this entry lists buckets, each an architecture,
its weight tying and VAE flag and its settings (lr, keep probability,
penalty, activation); every setting trains on every fold of the cell's
study.  Set-up draws each bucket's initial parameters on the device, and
takes the program's readings for the check (``readings``), which are also
the warm-up of every bucket shape: each bucket's first window call is
run for 1, 2 and 3 steps through the entry, and for one step through the
kernels' own run so that the optimizer's state can be read.  After the
window the reference (``reference/phase1.py``) follows the same three
steps from the same inputs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port import judge
from bench_port.entry_tools import as_mmae_params, draw_params, flat, \
    from_mmae_params, noise_of
from bench_port.reference import common, phase1
from bench_port.yardstick import bounds, flops

KIND = "phase1_step"


class Session:
    """The cell's buckets through the entry, on ``device``."""

    def __init__(self, doc: dict, traffic: dict, study, device, seeds):
        from multimodalautoencoder_tpu_torch.config import MMAEConfig, \
            TrainConfig
        from multimodalautoencoder_tpu_torch.data.modalities import \
            ModalityTable
        from multimodalautoencoder_tpu_torch.models.corruption import \
            NoiseSpec
        from multimodalautoencoder_tpu_torch.parallel import grid_trainer

        self.gt = grid_trainer
        self.doc, self.study = doc, study
        self.device = torch.device(device)
        self.seeds = seeds
        self.steps = int(traffic["steps_per_call"])
        if self.steps != int(doc["num_steps"]):
            raise ValueError(f"steps_per_call {self.steps} differs from the "
                             f"configuration's num_steps {doc['num_steps']}")
        m, r = doc["model"], doc["recipe"]
        self.K = study.num_folds
        F = study.num_feats
        starts = tuple(int(s) for s in np.concatenate(
            [[0], np.cumsum(study.widths)]))
        table = ModalityTable(names=tuple(study.names), start_indices=starts,
                              num_feats=F)
        self.base = MMAEConfig(
            num_feats=F, loss=m["loss"], normalization=m["normalization"],
            mask_with=m["mask_with"], fill_missing_with=m["fill_missing_with"],
            intelligent_noise=m["intelligent_noise"],
            num_modalities_to_drop=m["num_modalities_to_drop"],
            element_dropout_frac=m["element_dropout_frac"],
            noise_types=tuple(tuple(t) for t in m["noise_types"]),
            noise_type_percentages=tuple(m["noise_type_percentages"]),
            weight_initialization=m["weight_initialization"])
        self.spec = NoiseSpec.build(self.base.validate(), table)
        self.tcfg = TrainConfig(
            learning_rate=r["learning_rate"], batch_size=r["batch_size"],
            num_steps=self.steps, decay=r["decay"],
            decay_steps=r["decay_steps"], decay_rate=r["decay_rate"],
            clip_gradients=r["clip_gradients"], optimizer=r["optimizer"],
            optimizer_state_dtype=r["moments"])
        self.folded = grid_trainer.FoldedData.from_ragged(
            study.train_x, study.val_x, device=self.device)
        self.noise = noise_of(doc, study)
        self.buckets: List[dict] = []
        for bi, b in enumerate(traffic["buckets"]):
            H1, H2 = (int(a) for a in b["architecture"])
            vae = bool(b["variational"])
            tied = bool(b["tie_weights"]) and not vae
            cfg = self.base.replace(layer_sizes=(H1, H2), tie_weights=tied,
                                    variational=vae).validate()
            settings = [{"learning_rate": s["learning_rate"],
                         "dropout_prob": s["dropout_prob"],
                         "weight_penalty": s["weight_penalty"],
                         "activation_function": s["activation"]}
                        for s in b["settings"]]
            hyper = grid_trainer.HyperStack.from_settings(settings, cfg,
                                                          self.tcfg)
            C = len(settings)
            gen = torch.Generator(device=self.device).manual_seed(
                seeds.params(bi))
            p0 = draw_params(gen, F, H1, H2, tied, vae, (C, self.K),
                             self.device)
            self.buckets.append({
                "name": b["name"], "cfg": cfg, "hyper": hyper, "p0": p0,
                "C": C, "N": C * self.K, "dims": (F, H1, H2), "tied": tied,
                "vae": vae, "settings": b["settings"]})

    # ------------------------------------------------------------ window

    def call(self, bi: int, call_seed: int, steps: Optional[int] = None):
        """One call of the entry on bucket ``bi``; each call trains a copy
        of the bucket's initial parameters (the entry trains a given
        device stack in place)."""
        b = self.buckets[bi]
        p0 = {k: t.clone() for k, t in b["p0"].items()}
        return self.gt.train_grid_sharded(
            self.device, call_seed, b["cfg"], self.tcfg, self.spec,
            b["hyper"], self.folded,
            num_steps=self.steps if steps is None else steps,
            backend="pallas", params0=as_mmae_params(p0))

    @staticmethod
    def read(handle) -> np.ndarray:
        """The call's objective on the host, as the sweep's finalize
        reads it."""
        return handle[1].cpu().numpy()

    def work(self, bi: int) -> dict:
        """The frozen yardstick of one call of bucket ``bi``."""
        b = self.buckets[bi]
        F, H1, H2 = b["dims"]
        r = self.doc["recipe"]
        bnd = bounds.step_bound(F, H1, H2, b["tied"], b["vae"], b["N"],
                                int(r["batch_size"]),
                                r["moments"] == "bfloat16")
        fl = flops.train_step_flops(F, H1, H2, b["tied"], b["vae"],
                                    int(r["batch_size"]))
        return {"kind": KIND, "inst": b["N"], "steps": self.steps,
                "bound_s": bnd["bound_s"] * self.steps,
                "mxu_flop": fl["mxu"] * b["N"] * self.steps}

    # ------------------------------------------------------------- check

    def readings(self) -> List[dict]:
        """The program's readings of each bucket's first window call:
        its objective after 1, 2 and 3 steps, the norm of each leaf's
        change after 3, and each leaf's first moment after one step, read
        from the kernels' run state.  Leaves are (instance, tensor)."""
        from multimodalautoencoder_tpu_torch.ops import train_kernels as tk

        train, n_train = common.pad_folds(self.study.train_x, self.device)
        val, n_val = common.pad_folds(self.study.val_x, self.device)
        out = []
        for bi, b in enumerate(self.buckets):
            s = self.seeds.call(bi)
            objs = []
            for k in (1, 2, 3):
                params, losses = self.call(bi, s, steps=k)
                objs.append(losses.double().cpu())
            got = flat(from_mmae_params(params), b["N"])
            p0 = flat(b["p0"], b["N"])
            d3 = common.leaf_norms({k: got[k] - p0[k] for k in got})
            # the objective the reference reads off the entry's own
            # parameters: the entry's answer is judged against it
            judged = phase1.start(s, got, b["settings"], self.K, train,
                                  n_train, self.noise, self.doc["recipe"],
                                  b["tied"], b["vae"], self.device)
            obj_self = phase1.objective(judged, s, val, n_val, self.noise,
                                        b["C"], self.K).double().cpu()
            del params, got, judged
            g = torch.Generator().manual_seed(int(s))
            run = tk.prepare_run(g, b["cfg"], self.tcfg, self.spec,
                                 b["hyper"], self.folded,
                                 as_mmae_params({k: t.clone() for k, t in
                                                 b["p0"].items()}))
            tk.run_steps(run, 1, tk.train_grid_kernel_reference,
                         tk.train_grid_kernel)
            m1 = common.leaf_norms({name: t for name, t in
                                    zip(phase1.SLOTS, run.m)
                                    if t is not None})
            del run
            out.append({"obj": torch.stack(objs), "obj_self": obj_self,
                        "d3": {k: v.cpu() for k, v in d3.items()},
                        "m1": {k: v.cpu() for k, v in m1.items()}})
        return out

    def reference(self, prec: str = "f32", fault: Optional[str] = None
                  ) -> List[dict]:
        """The reference's readings of the same calls, and each leaf's
        unrounded first gradient; with ``prec`` or ``fault`` it stands in
        the program's place as the check's control or a fault."""
        train, n_train = common.pad_folds(self.study.train_x, self.device)
        val, n_val = common.pad_folds(self.study.val_x, self.device)
        recipe = dict(self.doc["recipe"])
        out = []
        for bi, b in enumerate(self.buckets):
            s = self.seeds.call(bi)
            run = phase1.start(s, flat(b["p0"], b["N"]), b["settings"],
                               self.K, train, n_train, self.noise, recipe,
                               b["tied"], b["vae"], self.device)
            objs, g1, m1 = [], None, None
            for k in range(3):
                grads = phase1.step(run, k, prec, fault)
                if k == 0:
                    g1 = common.leaf_norms(grads)
                    m1 = common.leaf_norms(phase1.moments(run))
                objs.append(phase1.objective(run, s, val, n_val, self.noise,
                                             b["C"], self.K, prec
                                             ).double().cpu())
            obj_self = objs[-1] if prec == "f32" else phase1.objective(
                run, s, val, n_val, self.noise, b["C"], self.K).double().cpu()
            p0 = flat(b["p0"], b["N"])
            d3 = common.leaf_norms({k: t - p0[k] for k, t in
                                    phase1.trained(run).items()})
            out.append({"obj": torch.stack(objs), "obj_self": obj_self,
                        "d3": {k: v.cpu() for k, v in d3.items()},
                        "m1": {k: v.cpu() for k, v in m1.items()},
                        "g1": {k: v.cpu() for k, v in g1.items()}})
            del run
        return out

    @staticmethod
    def numbers(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
        """The compared numbers, each the worst over the buckets."""
        return judge.worst([judge.training_numbers(p, r, loss="obj")
                            for p, r in zip(prog, ref)])

    def free(self) -> None:
        """Drop the program's inputs and state before the reference."""
        self.folded = None


def open_session(doc, traffic, study, device, seeds) -> Session:
    """The entry's session of a cell: ``doc`` its configuration,
    ``traffic`` its traffic file, ``study`` the run's data, ``seeds`` the
    run's ``window.Seeds``."""
    return Session(doc, traffic, study, device, seeds)
