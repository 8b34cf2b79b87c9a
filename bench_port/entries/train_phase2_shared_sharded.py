"""Adapter of the program entry
``parallel/grid_trainer.train_phase2_shared_sharded`` (phase 2 of the
classification sweep: one bucket of settings a call, on phase-1 stacks
shared by a family, on the phase-2 kernels).

A traffic file that names this entry lists the phase-1 families (the
encoder's shape and its U unique MMAE settings) and the phase-2 buckets,
each its family, its head's hidden widths, its settings and their
``p1_map``, the family row each setting starts from.  Set-up draws every
family's phase-1 stack on the device and takes the program's readings for
the check, which are also the warm-up of every bucket shape: each
bucket's first window call run for 1, 2 and 3 steps through the entry
(its val logits are read from its parameters by the reference's forward,
its predictions are kept), and for one step through the kernels' own run
so that the optimizer's state can be read.  After the window the
reference (``reference/phase2.py``) follows the same three steps.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench_port import judge
from bench_port.entry_tools import as_mmae_params, draw_params, noise_of
from bench_port.reference import common, phase2
from bench_port.yardstick import bounds, flops

KIND = "phase2_step"


class Session:
    """The cell's phase-2 buckets through the entry, on ``device``."""

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
        if self.steps != int(doc["cls_num_steps"]):
            raise ValueError(f"steps_per_call {self.steps} differs from the "
                             f"configuration's cls_num_steps "
                             f"{doc['cls_num_steps']}")
        m, r, r1 = doc["model"], doc["recipe"], doc["mmae_recipe"]
        self.K = K = study.num_folds
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
            weight_initialization=m["weight_initialization"],
            num_labels=m["num_labels"],
            classification_loss=m["classification_loss"],
            faithful_classify_gate=m["faithful_classify_gate"],
            compute_dtype="float32")
        self.spec = NoiseSpec.build(self.base.validate(), table)
        self.tcfg = TrainConfig(
            learning_rate=r1["learning_rate"], batch_size=r1["batch_size"],
            clip_gradients=False, optimizer=r1["optimizer"],
            optimizer_state_dtype=r1["moments"])
        self.cls_tcfg = TrainConfig(
            learning_rate=r["learning_rate"], batch_size=r["batch_size"],
            num_steps=self.steps, clip_gradients=r["clip_gradients"],
            optimizer=r["optimizer"], optimizer_state_dtype=r["moments"])
        self.folded = grid_trainer.FoldedData.from_ragged(
            study.train_x, study.val_x, device=self.device,
            train_y_list=study.train_y, val_y_list=study.val_y)
        self.noise = noise_of(doc, study)
        self.families: Dict[str, dict] = {}
        for fi, (name, f) in enumerate(sorted(traffic["families"].items())):
            H1, H2 = (int(a) for a in f["mmae_architecture"])
            vae = bool(f["variational"])
            tied = bool(f["tie_weights"]) and not vae
            gen = torch.Generator(device=self.device).manual_seed(
                seeds.params(1000 + fi))
            stack = draw_params(gen, F, H1, H2, tied, vae,
                                (len(f["settings"]), K), self.device)
            self.families[name] = {"stack": stack, "dims": (F, H1, H2),
                                   "tied": tied, "vae": vae,
                                   "params_u": as_mmae_params(stack)}
        self.buckets: List[dict] = []
        for b in traffic["buckets"]:
            fam = self.families[b["family"]]
            F, H1, H2 = fam["dims"]
            head = tuple(int(w) for w in b["classification_layers"])
            cfg = self.base.replace(
                layer_sizes=(H1, H2), classification_layer_sizes=head,
                tie_weights=fam["tied"], variational=fam["vae"]).validate()
            mm_settings = [{"dropout_prob": s["mmae_dropout_prob"],
                            "weight_penalty": s["mmae_weight_penalty"],
                            "activation_function": s["mmae_activation"]}
                           for s in b["settings"]]
            cls_settings = [{"dropout_prob": s["dropout_prob"],
                             "weight_penalty": s["weight_penalty"],
                             "activation_func": s["activation"]}
                            for s in b["settings"]]
            C = len(b["settings"])
            self.buckets.append({
                "name": b["name"], "cfg": cfg, "family": b["family"],
                "hyper": grid_trainer.HyperStack.from_settings(
                    mm_settings, cfg, self.tcfg),
                "chyper": grid_trainer.ClassifierHyperStack.from_settings(
                    cls_settings, cfg),
                "p1_map": np.asarray(b["p1_map"], np.int64), "C": C,
                "N": C * K, "head": head, "settings": b["settings"]})

    # ------------------------------------------------------------ window

    def call(self, bi: int, call_seed: int, steps: Optional[int] = None):
        b = self.buckets[bi]
        return self.gt.train_phase2_shared_sharded(
            self.device, call_seed, b["cfg"], self.tcfg, self.cls_tcfg,
            self.spec, self.families[b["family"]]["params_u"], b["p1_map"],
            b["hyper"], b["chyper"], self.folded,
            cls_num_steps=self.steps if steps is None else steps,
            backend="pallas")

    @staticmethod
    def read(handle) -> np.ndarray:
        """The call's val predictions on the host, as the sweep's metric
        battery reads them."""
        return handle[1].cpu().numpy()

    def work(self, bi: int) -> dict:
        b = self.buckets[bi]
        F, H1, H2 = self.families[b["family"]]["dims"]
        vae = self.families[b["family"]]["vae"]
        r, L = self.doc["recipe"], int(self.doc["model"]["num_labels"])
        bnd = bounds.cls_step_bound(F, H1, H2, b["head"], L, vae, b["N"],
                                    int(r["batch_size"]),
                                    r["moments"] == "bfloat16")
        fl = flops.cls_train_step_flops(F, H1, H2, b["head"], L, vae,
                                        int(r["batch_size"]))
        return {"kind": KIND, "inst": b["N"], "steps": self.steps,
                "bound_s": bnd["bound_s"] * self.steps,
                "mxu_flop": fl["mxu"] * b["N"] * self.steps}

    # ------------------------------------------------------------- check

    def _encoder(self, b) -> Dict[str, torch.Tensor]:
        """The (N, ...) encoder each instance of bucket ``b`` starts from:
        its setting's family row on its fold."""
        stack = self.families[b["family"]]["stack"]
        idx = torch.as_tensor(b["p1_map"], device=self.device)
        return {k: stack[k][idx].reshape((b["N"],) + tuple(
            stack[k].shape[2:])) for k in ("w1", "b1", "w2", "b2", "wv", "bv")
            if k in stack}

    def _judge_run(self, bi: int, seed: int, device) -> phase2.Run:
        """A reference state of bucket ``bi``'s call (fresh heads, keys,
        gates, activations and evaluation noise), to read logits with."""
        b = self.buckets[bi]
        fam = self.families[b["family"]]
        train, n_train = common.pad_folds(self.study.train_x, device)
        labels, _ = common.pad_folds(self.study.train_y, device)
        val_rows = max(v.shape[0] for v in self.study.val_x)
        dims = [fam["dims"][2]] + list(b["head"]) \
            + [int(self.doc["model"]["num_labels"])]
        return phase2.start(seed, self._encoder(b), b["settings"], self.K,
                            train, labels, n_train, self.noise,
                            self.doc["recipe"], dims, fam["vae"], val_rows,
                            device)

    def _val(self):
        val, n_val = common.pad_folds(self.study.val_x, self.device)
        vy, _ = common.pad_folds(self.study.val_y, self.device)
        return val, n_val, vy

    def readings(self) -> List[dict]:
        """The program's readings of each bucket's first window call: its
        val loss after 1, 2 and 3 steps (from its parameters, by the
        reference's forward), its predictions and logits after 3, the norm
        of each leaf's change after 3, and each leaf's first moment after
        one step, read from the kernels' run state."""
        from multimodalautoencoder_tpu_torch.ops import cls_train_kernels \
            as ck
        from multimodalautoencoder_tpu_torch.ops import optim
        from multimodalautoencoder_tpu_torch.ops import train_kernels as tk

        val, n_val, vy = self._val()
        out = []
        for bi, b in enumerate(self.buckets):
            s = self.seeds.call(bi)
            jr = self._judge_run(bi, s, self.device)
            start = phase2.trained(jr)
            losses = []
            for k in (1, 2, 3):
                params, preds = self.call(bi, s, steps=k)
                got = _flat_params(params, b["N"])
                logits = phase2.val_logits(got, jr, val, b["C"])
                losses.append(judge.val_loss(logits, vy, n_val, b["C"]))
            d3 = common.leaf_norms({k: got[k] - start[k] for k in start})
            reading = {"loss": torch.stack(losses),
                       "logits3": logits.cpu(), "preds3": preds.cpu(),
                       "d3": {k: v.cpu() for k, v in d3.items()}}
            del params, got, jr
            g = torch.Generator().manual_seed(int(s))
            head0 = ck.init_heads(g, b["cfg"], b["C"], self.K)
            params1 = optim.tree_map(
                lambda t: t[torch.as_tensor(b["p1_map"], device=t.device)],
                self.families[b["family"]]["params_u"])
            run = ck.prepare_cls_run(g, b["cfg"], self.cls_tcfg, self.spec,
                                     b["hyper"], b["chyper"], self.folded,
                                     params1, head0)
            tk.run_steps(run, 1, ck.train_cls_kernel_reference,
                         ck.train_cls_kernel)
            reading["m1"] = {k: v.cpu() for k, v in common.leaf_norms(
                {name: t for name, t in zip(phase2.SLOTS, run.m)
                 if t is not None}).items()}
            del run
            out.append(reading)
        return out

    def reference(self, prec: str = "f32", fault: Optional[str] = None
                  ) -> List[dict]:
        """The reference's readings of the same calls (with each leaf's
        unrounded first gradient); with ``prec`` or ``fault`` it stands in
        the program's place."""
        val, n_val, vy = self._val()
        out = []
        for bi, b in enumerate(self.buckets):
            s = self.seeds.call(bi)
            run = self._judge_run(bi, s, self.device)
            start = {k: t.clone() for k, t in phase2.trained(run).items()}
            losses, g1, m1 = [], None, None
            for k in range(3):
                grads = phase2.step(run, k, prec, fault)
                if k == 0:
                    g1 = common.leaf_norms(grads)
                    m1 = common.leaf_norms(phase2.moments(run))
                own = phase2.val_logits(phase2.trained(run), run, val, b["C"],
                                        prec)
                judged = phase2.val_logits(phase2.trained(run), run, val,
                                           b["C"])
                losses.append(judge.val_loss(judged, vy, n_val, b["C"]))
            d3 = common.leaf_norms({k: t - start[k] for k, t in
                                    phase2.trained(run).items()})
            out.append({"loss": torch.stack(losses),
                        "logits3": judged.cpu(),
                        "preds3": phase2.predictions(own).cpu(),
                        "d3": {k: v.cpu() for k, v in d3.items()},
                        "m1": {k: v.cpu() for k, v in m1.items()},
                        "g1": {k: v.cpu() for k, v in g1.items()}})
            del run
        return out

    def numbers(self, prog: List[dict], ref: List[dict]) -> Dict[str, float]:
        _, n_val, _ = self._val()
        rows = []
        for p, r in zip(prog, ref):
            nums = judge.training_numbers(p, r, loss="loss")
            C = p["logits3"].shape[0] // self.K
            nums["pred_miss"] = judge.pred_miss(
                p["preds3"], p["logits3"], n_val.cpu(), C)
            rows.append(nums)
        return judge.worst(rows)

    def free(self) -> None:
        self.folded = None


def _flat_params(params, N: int) -> Dict[str, torch.Tensor]:
    """The trained slots of the entry's result, flat over instances."""
    out = {"w1": params.enc_w[0], "b1": params.enc_b[0],
           "w2": params.enc_w[1], "b2": params.enc_b[1]}
    if params.var_w is not None:
        out["wv"], out["bv"] = params.var_w, params.var_b
    for j, (w, bb) in enumerate(zip(params.cls_w, params.cls_b)):
        out[phase2.SLOTS[6 + 2 * j]] = w
        out[phase2.SLOTS[7 + 2 * j]] = bb
    return {k: t.reshape((N,) + tuple(t.shape[2:])) for k, t in out.items()}


def open_session(doc, traffic, study, device, seeds) -> Session:
    """The entry's session of a cell: ``doc`` its configuration,
    ``traffic`` its traffic file, ``study`` the run's data, ``seeds`` the
    run's ``window.Seeds``."""
    return Session(doc, traffic, study, device, seeds)
