"""High-level MMAE facade: the reference's ``MultimodalAutoencoder`` class
(multimodal_autoencoder.py:58-1216) on one torch device.

Counterpart of ``multimodalautoencoder_tpu/api.py``, with one argument more,
``device`` (default ``"cuda"``; there is no fallback to another device).
Construction builds the configs and puts the data on the device;
``train`` / ``train_classification`` run ``train/trainer.py``; every
evaluation and utility method of the reference has a counterpart.

Method map (reference -> here):
  train (:549)                      -> train
  train_classification (:606)       -> train_classification
  predict (:932)                    -> predict
  get_embedding (:1062)             -> get_embedding
  get_classification_predictions (:1035) -> get_classification_predictions
  get_performance_on_data (:1005)   -> get_performance_on_data
  get_performance_on_data_with_noise (:1019) -> ..._with_noise
  test_on_validation/test (:987,:995) -> test_on_validation / test_on_test
  get_reconstruction_loss_per_modality (:1189) -> same
  save_model/load_saved_model (:766,:803) -> save_model / load_saved_model
  set_classification_params (:898)  -> set_classification_params
  convert_file_to_embeddings (:1135)-> same (bug 2.8.4 fixed)
  fill_missing_data_in_file (:1167) -> same
  plot_training_progress (:952)     -> same (utils/plotting.py)
  view_reconstruction (:1103)       -> view_reconstruction
  get_performance_on_extra_noisy_data (:1082) -> same
  add_noise_to_batch (:668)         -> add_noise_to_batch

Where the JAX facade returns a pandas DataFrame
(``get_classification_predictions_from_df``), this returns a
``data/loader.Frame`` with the same columns.  Checkpoints are the JAX
package's format both ways, optimizer state included: a port checkpoint's
``opt`` / ``cls_opt`` states restore their Adam moments and step in the
JAX facade, which finds its key leaf where it keeps its key; the port's
generator travels in the states ``opt_generator`` / ``cls_opt_generator``.
A JAX checkpoint restores its moments and step here, and the generator
then starts fresh from the seed.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from multimodalautoencoder_tpu_torch.config import (ClassifierTrainConfig,
                                                    MMAEConfig, TrainConfig)
from multimodalautoencoder_tpu_torch.data.loader import DataLoader, Frame
from multimodalautoencoder_tpu_torch.models.corruption import (
    NoiseSpec, add_noise_to_batch)
from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt_lib
from multimodalautoencoder_tpu_torch.train import trainer


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _copy_generator(g: torch.Generator) -> torch.Generator:
    """A second generator in ``g``'s state (the JAX facade hands phase 2 a
    copy of phase 1's key)."""
    return torch.Generator(device=g.device).set_state(g.get_state())


def _key_leaf(g: torch.Generator) -> torch.Tensor:
    """The leaf written where the JAX package keeps its PRNG key: a (2,)
    uint32 key of the generator's seed, ``jax.random.PRNGKey(seed)``'s
    layout.  The port restores from the generator's own state instead."""
    seed = g.initial_seed()
    return torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                        dtype=torch.uint32)


class MultimodalAutoencoder:
    """Stateful convenience wrapper over the functional core."""

    def __init__(self, filename: Optional[str] = None,
                 layer_sizes: Sequence[int] = (128, 64, 32),
                 variational: bool = True, tie_weights: bool = True,
                 batch_size: int = 10, learning_rate: float = 1e-4,
                 dropout_prob: float = 1.0, weight_penalty: float = 0.0,
                 activation_func: str = "softsign",
                 loss_func: str = "sigmoid_cross_entropy",
                 decay: bool = True, decay_steps: int = 1000,
                 decay_rate: float = 0.95, clip_gradients: bool = True,
                 classification_layer_sizes: Optional[Sequence[int]] = None,
                 classification_filename: Optional[str] = None,
                 weight_initialization: str = "xavier",
                 normalization: str = "between_0_and_1",
                 intelligent_noise: bool = True,
                 num_modalities_to_drop: int = 1,
                 subdivide_physiology: bool = True,
                 fill_missing_with: float = 0.0, mask_with: float = -1.0,
                 checkpoint_dir: str = "checkpoints",
                 model_name: str = "multimodal_autoencoder",
                 extra_data_filename: Optional[str] = None,
                 data_loader: Optional[DataLoader] = None,
                 classification_data_loader: Optional[DataLoader] = None,
                 seed: int = 0, verbose: bool = True,
                 compute_dtype: str = "float32",
                 normalize_and_fill: bool = False,
                 fill_gaps_with: Optional[float] = None,
                 device="cuda", engine: str = "pandas"):
        """The reference constructor's knobs (:59-70), plus
        ``normalize_and_fill`` / ``fill_gaps_with`` (the reference always
        builds its loader with normalize_and_fill=False, :190-194, assuming
        cleaned files), ``device``, where the model and data live, and
        ``engine``, the CSV reader of the loaders built here
        (:class:`DataLoader`)."""
        # the reference applies the VAE / z-score+entropy overrides before
        # building its loader (multimodal_autoencoder.py:174-194), so the
        # loaders see the effective normalization; MMAEConfig.validate
        # applies the same two rules
        if variational or (normalization == "z_score"
                           and "entropy" in loss_func):
            normalization = "between_0_and_1"
        self.device = torch.device(device)

        if data_loader is not None:
            self.data_loader = data_loader
        elif filename is not None:
            self.data_loader = DataLoader(
                filename, supervised=False,
                subdivide_physiology_features=subdivide_physiology,
                normalize_and_fill=normalize_and_fill,
                normalization=normalization,
                fill_missing_with=fill_missing_with,
                fill_gaps_with=fill_gaps_with, seed=seed, engine=engine)
        else:
            raise ValueError("must set either filename or data_loader")

        self.classification_data_loader = classification_data_loader
        if (classification_layer_sizes is not None
                and classification_data_loader is None
                and classification_filename is not None):
            self.classification_data_loader = DataLoader(
                classification_filename, supervised=True,
                subdivide_physiology_features=subdivide_physiology,
                normalize_and_fill=normalize_and_fill,
                normalization=normalization,
                fill_missing_with=fill_missing_with,
                fill_gaps_with=fill_gaps_with, seed=seed, engine=engine)
        # head width from the classification loader's label count, as the
        # reference (:323-327: 2 when unset)
        cls_dl = self.classification_data_loader
        num_labels = (len(cls_dl.wanted_labels)
                      if cls_dl is not None and cls_dl.wanted_labels
                      else 2)

        self.cfg = MMAEConfig(
            num_feats=self.data_loader.num_feats,
            layer_sizes=tuple(layer_sizes), variational=variational,
            tie_weights=tie_weights, dropout_prob=dropout_prob,
            weight_penalty=weight_penalty, activation=activation_func,
            loss=loss_func, weight_initialization=weight_initialization,
            normalization=normalization,
            intelligent_noise=intelligent_noise,
            num_modalities_to_drop=num_modalities_to_drop,
            fill_missing_with=fill_missing_with, mask_with=mask_with,
            num_labels=num_labels,
            classification_layer_sizes=(
                None if classification_layer_sizes is None
                else tuple(classification_layer_sizes)),
            compute_dtype=compute_dtype).validate()
        self.tcfg = TrainConfig(
            learning_rate=learning_rate, batch_size=batch_size,
            decay=decay, decay_steps=decay_steps, decay_rate=decay_rate,
            clip_gradients=clip_gradients, seed=seed)
        # phase-2 defaults (:215-220)
        self.classification_tcfg = ClassifierTrainConfig(seed=seed)

        self.spec = NoiseSpec.build(self.cfg,
                                    self.data_loader.modality_table)
        self.checkpoint_dir = checkpoint_dir
        self.model_name = model_name
        self.extra_data_filename = extra_data_filename
        self.extra_noisy_data_loader: Optional[DataLoader] = None
        self.verbose = verbose
        self.seed = seed

        self._arrays = self.data_loader.device_arrays(self.device)
        self._cls_arrays = (
            self.classification_data_loader.device_arrays(self.device)
            if self.classification_data_loader is not None else None)
        if self._cls_arrays is not None and \
                self.cfg.classification_loss == "sigmoid_cross_entropy":
            # single-label loaders give 1-D Y (data_funcs.py:521-524);
            # per-label sigmoid-CE needs (N, num_labels), or (B, 1) logits
            # would broadcast against (B,) labels into (B, B)
            for k in ("train_y", "val_y", "test_y"):
                y = self._cls_arrays.get(k)
                if y is not None and y.dim() == 1:
                    self._cls_arrays[k] = y[:, None]
        self.state = trainer.init_state(seed, self.cfg, self.tcfg,
                                        self.device)
        # phase-2 optimizer slots live apart, like the reference's second
        # minimize() owning its own slot variables (:443): a phase-1
        # train() after train_classification must not take the
        # classification objective's Adam moments
        self._cls_state = None
        self._noise_generator = _generator(self.device, seed + 1)
        self.train_loss: list = []
        self.val_loss: list = []
        self.train_acc: list = []
        self.val_acc: list = []
        self.classification_train_loss: list = []
        self.classification_val_loss: list = []
        self.record_every_nth = 50        # (:166)
        self.save_every_nth = 100_000     # (:167)

    # -- properties --------------------------------------------------------

    @property
    def params(self):
        return self.state.params

    @property
    def embedding_size(self) -> int:
        return self.cfg.embedding_size

    def rebuild_reinitialize(self) -> None:
        """Fresh parameters and optimizer state (:243-254)."""
        self.state = trainer.init_state(self.seed, self.cfg, self.tcfg,
                                        self.device)
        self._cls_state = None
        self.train_loss, self.val_loss = [], []

    def set_classification_params(self, weight_penalty=None,
                                  learning_rate=None, dropout_prob=None,
                                  activation_func=None, batch_size=None,
                                  loss_func=None,
                                  suppress_warning: bool = True) -> None:
        """Override phase-2 hyperparameters; resets the parameters like the
        reference's graph rebuild (:898-930)."""
        kw = {}
        if learning_rate is not None:
            kw["learning_rate"] = learning_rate
        if batch_size is not None:
            kw["batch_size"] = int(batch_size)
        self.classification_tcfg = self.classification_tcfg.replace(**kw)
        ckw = {}
        if weight_penalty is not None:
            ckw["classification_weight_penalty"] = weight_penalty
        if activation_func is not None:
            ckw["classification_activation"] = activation_func
        if loss_func is not None:
            ckw["classification_loss"] = loss_func
        if dropout_prob is not None:
            ckw["dropout_prob"] = dropout_prob
        if ckw:
            self.cfg = self.cfg.replace(**ckw).validate()
        self.rebuild_reinitialize()

    def set_record_save(self, record_every_nth: Optional[int] = None,
                        save_every_nth: Optional[int] = None) -> None:
        """Keep the loss-recording / checkpoint cadence (:592-605); None
        leaves a value as it is.  Non-positive values are refused (the
        reference's ``step % 0`` crash)."""
        for name, v in (("record_every_nth", record_every_nth),
                        ("save_every_nth", save_every_nth)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if record_every_nth is not None:
            self.record_every_nth = record_every_nth
        if save_every_nth is not None:
            self.save_every_nth = save_every_nth

    # -- training ----------------------------------------------------------

    def _chunks(self, num_steps: int):
        """Step counts of the runs between checkpoints: ``save_every_nth``
        at a time (:584-586), the last one shorter."""
        chunk = (num_steps if self.save_every_nth >= num_steps
                 else self.save_every_nth)
        done = 0
        while done < num_steps:
            n = min(chunk, num_steps - done)
            yield n
            done += n
            if done < num_steps:
                self.save_model()

    def train(self, num_steps: int = 30000,
              record_every_nth: Optional[int] = None,
              save_every_nth: Optional[int] = None) -> None:
        """Unsupervised denoising training (:549-590), checkpointed every
        ``save_every_nth`` steps mid-run like the reference (:584-586).
        Both cadences persist across calls (:563, :592-605).  When
        ``save_every_nth < record_every_nth`` each chunk records a trailing
        point, as the JAX facade's chunks do."""
        self.set_record_save(record_every_nth, save_every_nth)
        for n in self._chunks(num_steps):
            tcfg = self.tcfg.replace(num_steps=n,
                                     record_every_nth=self.record_every_nth)
            self.state, curves = trainer.train(
                self.state, self.cfg, tcfg, self.spec,
                self._arrays["train_x"], self._arrays["val_x"])
            self.train_loss += list(curves.train_loss)
            self.val_loss += list(curves.val_loss)
        if self.save_every_nth <= num_steps:
            self.save_model()
        if self.verbose and self.val_loss:
            print(f"trained {num_steps} steps; final val loss "
                  f"{self.val_loss[-1]:.4f}")

    def train_classification(self, num_steps: int = 30000,
                             record_every_nth: Optional[int] = None,
                             save_every_nth: Optional[int] = None) -> None:
        """Phase-2 supervised training (:606-647), checkpointed like
        :meth:`train` (:641-643)."""
        if self._cls_arrays is None:
            raise ValueError("no classification data loader configured")
        self.set_record_save(record_every_nth, save_every_nth)
        if self._cls_state is None:
            state = trainer.state_for_params(
                self.state.params, self.classification_tcfg,
                _copy_generator(self.state.generator))
        else:
            # a resumed phase 2 keeps its own slots and step, like the
            # reference's per-optimizer slot variables (:443)
            state = self._cls_state._replace(params=self.state.params)
        arr = self._cls_arrays
        for n in self._chunks(num_steps):
            tcfg = self.classification_tcfg.replace(
                num_steps=n, record_every_nth=self.record_every_nth)
            state, curves = trainer.train_classification(
                state, self.cfg, tcfg, self.spec, arr["train_x"],
                arr["train_y"], arr["val_x"], arr["val_y"])
            self._cls_state = state
            # phase 1 keeps its own slots, step and generator; only the
            # parameters advance
            self.state = self.state._replace(params=state.params)
            self.classification_train_loss += list(curves.train_loss)
            self.classification_val_loss += list(curves.val_loss)
            self.train_acc += list(curves.train_acc)
            self.val_acc += list(curves.val_acc)
        if self.save_every_nth <= num_steps:
            self.save_model()

    # -- corruption --------------------------------------------------------

    def _tensor(self, X) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X, dtype=np.float32),
                               device=self.device)

    def add_noise_to_batch(self, X, missing_modes: Sequence[str] = (),
                           generator: Optional[torch.Generator] = None
                           ) -> np.ndarray:
        """Structured corruption of a batch (:668-702).  ``missing_modes``
        forces a fixed modality set, like the reference's argument."""
        forced = None
        if missing_modes:
            table = self.data_loader.modality_table
            forced = torch.as_tensor(
                table.noise_type_masks([list(missing_modes)])[0])
        return add_noise_to_batch(generator or self._noise_generator,
                                  self._tensor(X), self.spec,
                                  forced_type_mask=forced).cpu().numpy()

    # -- evaluation --------------------------------------------------------

    def predict(self, X):
        """(reconstruction, report-scaled loss) without noise (:932-950)."""
        recon, loss = trainer.predict(self.params, self.cfg, self._tensor(X))
        return recon.cpu().numpy(), float(loss)

    def get_performance_on_data(self, X) -> float:
        _, loss = self.predict(X)
        return loss

    def get_performance_on_data_with_noise(
            self, X, generator: Optional[torch.Generator] = None) -> float:
        """The loss on freshly corrupted X: each call draws new noise, as
        the reference's fresh np.random noise does (:1070-1074)."""
        return float(trainer.evaluate_reconstruction(
            self.params, self.cfg, self.spec, self._tensor(X),
            generator or self._noise_generator, add_noise=True))

    def test_on_validation(self) -> float:
        return self.get_performance_on_data(self.data_loader.val_X)

    def test_on_test(self) -> float:
        if self.verbose:
            print("WARNING! Only test on the test set when you have "
                  "finished choosing all of your hyperparameters!")
        return self.get_performance_on_data(self.data_loader.test_X)

    def get_performance_on_extra_noisy_data(self) -> float:
        """Reconstruction loss on an extra, genuinely noisy file
        (:1082-1101)."""
        if self.extra_noisy_data_loader is None:
            if self.extra_data_filename is None:
                raise ValueError("no extra_data_filename provided")
            # supervised=True: the reference builds this loader with the
            # DataLoader default (:1093-1098, data_funcs.py:30), which drops
            # rows lacking a label before scoring
            self.extra_noisy_data_loader = DataLoader(
                self.extra_data_filename, supervised=True,
                normalize_and_fill=False,
                subdivide_physiology_features=self.data_loader.subdivide_phys,
                normalization=self.cfg.normalization,
                fill_missing_with=self.cfg.fill_missing_with,
                fill_gaps_with=self.cfg.mask_with)
        return self.get_performance_on_data(
            self.extra_noisy_data_loader.train_X)

    def get_embedding(self, X, add_noise: bool = False) -> np.ndarray:
        return trainer.get_embedding(
            self.params, self.cfg, self._tensor(X),
            generator=self._noise_generator, add_noise=add_noise,
            spec=self.spec).cpu().numpy()

    def get_classification_predictions(self, X) -> np.ndarray:
        return trainer.classification_predictions(
            self.params, self.cfg, self._tensor(X),
            _generator(self.device, self.seed + 2)).cpu().numpy()

    def get_classification_predictions_from_df(self) -> Frame:
        """Predictions appended to the classification frame
        (:1047-1060), as ``predictions_<label>`` columns."""
        dl = self.classification_data_loader
        frame = dl.frame
        preds = self.get_classification_predictions(
            frame.matrix(dl.wanted_feats))
        if preds.ndim == 1:
            # softmax single-label mode: argmax predictions are 1-D (the
            # reference would crash here, :1056-1060)
            preds = preds[:, None]
        if preds.shape[1] != len(dl.wanted_labels):
            raise ValueError(
                f"model emits {preds.shape[1]} prediction column(s) but "
                f"the classification frame has {len(dl.wanted_labels)} "
                f"label(s) {dl.wanted_labels}; softmax mode predicts "
                "one class column, so use per-label sigmoid_cross_entropy "
                "for multi-label frames")
        return frame.with_columns(
            ["predictions_" + label for label in dl.wanted_labels],
            preds.astype(np.float64))

    def get_reconstruction_loss_per_modality(self, X) -> list:
        masks = torch.as_tensor(
            self.data_loader.modality_table.feature_masks())
        rms = trainer.reconstruction_loss_per_modality(
            self.params, self.cfg, masks, self._tensor(X))
        return list(rms.cpu().numpy())

    # -- persistence -------------------------------------------------------

    @staticmethod
    def _state_payload(state: trainer.TrainState):
        """(JAX-layout state, generator state) of a TrainState: its
        optimizer slots, step and a key-shaped leaf; and the generator's
        own state as bytes."""
        return ((state.opt_state, state.step, _key_leaf(state.generator)),
                (state.generator.get_state(),))

    def save_model(self, file_name: Optional[str] = None,
                   directory: Optional[str] = None) -> str:
        # optimizer slots, step and generator of both phases, the
        # equivalent of the reference Saver covering every variable
        # (:786-788): a reloaded model resumes training step for step
        states, tags = {}, {}
        for name, state, tcfg in (
                ("opt", self.state, self.tcfg),
                ("cls_opt", self._cls_state, self.classification_tcfg)):
            if state is None:
                continue
            states[name], states[name + "_generator"] = \
                self._state_payload(state)
            tags[name] = tcfg.optimizer
            tags[name + "_generator"] = self.device.type
        curves = {"train_loss": np.asarray(self.train_loss),
                  "val_loss": np.asarray(self.val_loss)}
        if self.classification_train_loss or self.train_acc:
            # phase-2 history travels with the phase-2 slots, so a
            # reloaded model's curves resume where its step says
            curves.update(
                classification_train_loss=np.asarray(
                    self.classification_train_loss),
                classification_val_loss=np.asarray(
                    self.classification_val_loss),
                train_acc=np.asarray(self.train_acc),
                val_acc=np.asarray(self.val_acc))
        return ckpt_lib.save_checkpoint(
            directory or self.checkpoint_dir,
            file_name or self.model_name, self.params, self.cfg,
            curves=curves,
            step=len(self.train_loss) * self.record_every_nth,
            states=states, state_tags=tags)

    def load_saved_model(self, directory: Optional[str] = None,
                         checkpoint_name: Optional[str] = None) -> None:
        directory = directory or self.checkpoint_dir
        if checkpoint_name is not None:
            path = os.path.join(directory, checkpoint_name)
        else:
            path = ckpt_lib.latest_checkpoint(directory)
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint found in {directory}")
        with ckpt_lib.CheckpointReader(path) as reader:
            params, cfg, curves, _ = reader.load_auto(
                self.cfg, verbose=self.verbose, device=self.device)
            self.cfg = cfg
            # the corruption spec derives from cfg (noise knobs, mask
            # value): rebuild it so later training and noisy evaluations
            # use the loaded settings
            self.spec = NoiseSpec.build(self.cfg,
                                        self.data_loader.modality_table)
            # optimizer slots, step and generator, like the reference's
            # saver.restore over all variables (:855-859); a mismatch falls
            # back to fresh slots around the loaded params
            self.state = self._restore_train_state(
                reader, "opt", params, self.tcfg, self.seed)
            self._cls_state = None
            if "cls_opt" in reader.state_names():
                self._cls_state = self._restore_train_state(
                    reader, "cls_opt", params, self.classification_tcfg,
                    self.seed + 3)
        self.train_loss = list(curves.get("train_loss", []))
        self.val_loss = list(curves.get("val_loss", []))
        self.classification_train_loss = list(
            curves.get("classification_train_loss", []))
        self.classification_val_loss = list(
            curves.get("classification_val_loss", []))
        self.train_acc = list(curves.get("train_acc", []))
        self.val_acc = list(curves.get("val_acc", []))

    def _restore_train_state(self, reader, name: str, params, tcfg,
                             fallback_seed: int) -> trainer.TrainState:
        """A TrainState from a checkpoint's saved optimizer state, or a
        fresh one around ``params`` when it is absent or does not match.
        The generator comes from the ``<name>_generator`` state when it was
        saved on this device type, else fresh from ``fallback_seed`` (a JAX
        checkpoint keeps a key, which the port cannot continue)."""
        fresh = trainer.state_for_params(
            params, tcfg, _generator(self.device, fallback_seed))
        try:
            restored = reader.restore_state(
                name, (fresh.opt_state, fresh.step,
                       torch.zeros(2, dtype=torch.uint32)),
                expect_tag=tcfg.optimizer)
        except ValueError as e:
            if self.verbose:
                print(f"WARNING! could not restore saved {name} state "
                      f"({e}); optimizer starts fresh.")
            restored = None
        if restored is None:
            return fresh
        opt_state, step, _ = restored
        generator = fresh.generator
        gen_name = name + "_generator"
        if gen_name in reader.state_names():
            try:
                (gen_state,) = reader.restore_state(
                    gen_name, (generator.get_state(),),
                    expect_tag=self.device.type)
                generator.set_state(gen_state)
            except ValueError as e:
                if self.verbose:
                    print(f"WARNING! could not restore saved {gen_name} "
                          f"({e}); the generator starts from the seed.")
        return trainer.TrainState(params=params, opt_state=opt_state,
                                  step=step, generator=generator)

    # -- file tools / plots ------------------------------------------------

    def convert_file_to_embeddings(self, filename: str, path: str = "",
                                   file_descriptor: str = "") -> str:
        from multimodalautoencoder_tpu_torch.tools import files

        return files.convert_file_to_embeddings(
            self.params, self.cfg, os.path.join(path, filename),
            file_descriptor=file_descriptor)

    def fill_missing_data_in_file(self, filename: str, path: str = "",
                                  file_descriptor: str = "") -> str:
        from multimodalautoencoder_tpu_torch.tools import files

        return files.fill_missing_data_in_file(
            self.params, self.cfg, self.data_loader,
            os.path.join(path, filename), file_descriptor=file_descriptor)

    def plot_training_progress(self, show: bool = True,
                               save_path: Optional[str] = None):
        from multimodalautoencoder_tpu_torch.utils import plotting

        return plotting.plot_training_progress(
            self.train_loss, self.val_loss, self.record_every_nth,
            show=show, save_path=save_path)

    def plot_classification_training_progress(self, show: bool = True,
                                              save_path=None):
        from multimodalautoencoder_tpu_torch.utils import plotting

        return plotting.plot_classification_training_progress(
            self.train_acc, self.val_acc, self.classification_train_loss,
            self.classification_val_loss, self.record_every_nth,
            show=show, save_path=save_path)

    def view_reconstruction(self, dataset, with_noise: bool = True,
                            show: bool = True, save_path=None):
        from multimodalautoencoder_tpu_torch.utils import plotting

        i = np.random.randint(0, len(dataset))
        X = np.reshape(np.asarray(dataset)[i], (1, -1))
        noisy = self.add_noise_to_batch(X) if with_noise else X
        recon, _ = self.predict(noisy)
        return plotting.view_reconstruction(
            X[0], recon[0], noisy[0] if with_noise else None, show=show,
            save_path=save_path)
