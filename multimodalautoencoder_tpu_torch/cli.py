"""Command-line interface of the port: serving, single-run training, the
two sweeps, the comparison baselines and feature selection.

Counterpart of ``multimodalautoencoder_tpu/cli.py``, every subcommand:

    python -m multimodalautoencoder_tpu_torch.cli train data.csv \\
        --arch 1000 100 --num-steps 30000 --normalize-and-fill
    python -m multimodalautoencoder_tpu_torch.cli fill data.csv \\
        --checkpoint best-15000.npz --normalize-and-fill [--device cuda]
    python -m multimodalautoencoder_tpu_torch.cli embed data.csv \\
        --checkpoint best-15000.npz --normalize-and-fill
    python -m multimodalautoencoder_tpu_torch.cli sweep-mmae \\
        unsup.csv [sup.csv] --normalize-and-fill [--device cuda]
    python -m multimodalautoencoder_tpu_torch.cli sweep-classification \\
        unsup.csv sup.csv [label] --normalize-and-fill [--device cuda]
    python -m multimodalautoencoder_tpu_torch.cli baseline {svm,rf,lr,nn} \\
        data.csv [label] --normalize-and-fill [--device cuda]
    python -m multimodalautoencoder_tpu_torch.cli feature-select \\
        data.csv pca 100 --backend jax --fill-missing 0 [--device cuda]
    python -m multimodalautoencoder_tpu_torch.cli sweep-mmae unsup.csv \\
        --normalize-and-fill --process-shard 0 2 --save-best-params
    python -m multimodalautoencoder_tpu_torch.cli merge-shards results \\
        MMAE-unsup --best-checkpoint best_mmae
    python -m multimodalautoencoder_tpu_torch.cli jobs jobs.txt

``--device`` (default ``cuda``) is where the model runs; there is no
fallback to another device.  The sweeps also take a comma-separated list
(``--device cuda:0,cuda:1``) and split each bucket over it;
``--process-shard I N`` sweeps the round-robin slice I of N into a ledger
shard, and ``merge-shards`` merges a generation of shards and names the
global winner among the shard-tagged checkpoints.  ``--seed`` seeds the
row shuffle of ``--normalize-and-fill``, the CV folds and every random
draw of the run (the JAX CLI seeds the same places).  ``--engine native``
reads CSVs with the C++ parser of ``csrc/csv_loader.cpp``
(``data/fast_csv.py``).
``baseline svm|rf|lr``, ``sweep-mmae --probe svm`` and ``feature-select
--backend sklearn`` need scikit-learn, which the port does not depend on:
without it they exit with an error that names it.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from multimodalautoencoder_tpu_torch.config import MMAEConfig
from multimodalautoencoder_tpu_torch.data.loader import DataLoader
from multimodalautoencoder_tpu_torch.sweep import wrappers
from multimodalautoencoder_tpu_torch.tools import files
from multimodalautoencoder_tpu_torch.train import checkpoint as ckpt


def _fill_gaps(args):
    # gap sentinel only in the 0-1 prep (svm.py:143-150 ->
    # data_funcs.py:386,416-420), as in the JAX CLI
    return (-1.0 if (args.normalize_and_fill
                     and args.normalization == "between_0_and_1") else None)


def _restore(args):
    dl = DataLoader(args.filename, supervised=False,
                    normalize_and_fill=args.normalize_and_fill,
                    normalization=args.normalization,
                    fill_gaps_with=_fill_gaps(args), suppress_output=True,
                    seed=args.seed, engine=args.engine)
    cfg = MMAEConfig(num_feats=dl.num_feats)
    params, cfg, _, _ = ckpt.load_checkpoint_auto(args.checkpoint, cfg,
                                                  device=args.device)
    trained_feats = params.enc_w[0].shape[0]
    if trained_feats != dl.num_feats:
        raise SystemExit(
            f"checkpoint {args.checkpoint} was trained on "
            f"{trained_feats} features but {args.filename} has "
            f"{dl.num_feats} — the wanted-feature sets must match")
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    return dl, cfg.validate(), params, generator


def cmd_fill(args) -> int:
    dl, cfg, params, generator = _restore(args)
    # pass the loader's table so --normalize-and-fill reaches the model
    out = files.fill_missing_data_in_file(params, cfg, dl, args.filename,
                                          frame=dl.frame,
                                          generator=generator)
    print("wrote:", out)
    return 0


def cmd_embed(args) -> int:
    dl, cfg, params, generator = _restore(args)
    out = files.convert_file_to_embeddings(params, cfg, args.filename,
                                           frame=dl.frame,
                                           generator=generator)
    print("wrote:", out)
    return 0


def cmd_train(args) -> int:
    from multimodalautoencoder_tpu_torch.api import MultimodalAutoencoder

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device; pass --device cpu to "
                         "train on the CPU")
    # the facade applies the reference's normalization/loss coercions
    # (multimodal_autoencoder.py:174-184) through MMAEConfig.validate
    model = MultimodalAutoencoder(
        filename=args.filename, layer_sizes=args.arch,
        variational=args.variational,
        normalize_and_fill=args.normalize_and_fill,
        normalization=args.normalization, fill_gaps_with=_fill_gaps(args),
        checkpoint_dir=args.checkpoint_dir, seed=args.seed,
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        device=args.device, engine=args.engine)
    model.train(num_steps=args.num_steps)
    path = model.save_model()
    print("checkpoint:", path)
    return 0


def _loader(path, supervised, args, wanted_label=None,
            labels_to_sign=False):
    """A cross-validation loader as the JAX CLI's ``_loader`` builds it."""
    return DataLoader(path, supervised=supervised, cross_validation=True,
                      normalize_and_fill=args.normalize_and_fill,
                      normalization=args.normalization,
                      fill_gaps_with=_fill_gaps(args),
                      wanted_label=wanted_label,
                      labels_to_sign=labels_to_sign, seed=args.seed,
                      suppress_output=True, engine=args.engine)


def _reject_z_score(args) -> None:
    """The MMAE sweeps train sigmoid-CE against 0-1-normalized inputs
    (autoencoder_wrapper.py:79-92)."""
    if args.normalization == "z_score":
        raise SystemExit(
            "--normalization z_score is only valid for 'baseline' "
            "commands; the MMAE sweeps train sigmoid-CE against "
            "0-1-normalized inputs")


def _sweep_devices(args):
    """``--device``, a comma-separated list of devices to split each
    bucket over."""
    devices = [d.strip() for d in args.device.split(",") if d.strip()]
    return devices if len(devices) > 1 else args.device


def _shard(args):
    return tuple(args.process_shard) if args.process_shard else None


def cmd_sweep_mmae(args) -> int:
    _reject_z_score(args)
    unsup = _loader(args.filename, False, args)
    cls = (_loader(args.classification_filename, True, args)
           if args.classification_filename else None)
    sweep = wrappers.MMAESweep(
        unsup, classification_data_loader=cls,
        results_path=args.results_path, cont=args.cont,
        check_test=args.check_test, num_cross_folds=args.folds,
        num_steps=args.num_steps, seed=args.seed, backend=args.backend,
        probe=None if args.probe == "none" else args.probe,
        process_shard=_shard(args), save_best_params=args.save_best_params,
        device=_sweep_devices(args))
    best, test_score, extras = sweep.run()
    print(best)
    if test_score is not None:
        print("held-out test:", test_score)
    for metric, row in extras.items():
        print(f"best by {metric}:", dict(row))
    return 0


def cmd_sweep_classification(args) -> int:
    _reject_z_score(args)
    unsup = _loader(args.mmae_filename, False, args)
    sup = _loader(args.classification_filename, True, args,
                  wanted_label=args.label)
    sweep = wrappers.MMAEClassificationSweep(
        unsup, sup, wanted_label=args.label,
        results_path=args.results_path, cont=args.cont,
        check_test=args.check_test, num_cross_folds=args.folds,
        mmae_num_steps=args.num_steps,
        classification_num_steps=args.num_steps, seed=args.seed,
        compute_dtype=args.compute_dtype, backend=args.backend,
        process_shard=_shard(args), save_best_params=args.save_best_params,
        device=_sweep_devices(args))
    for metric, row in sweep.run().items():
        if metric == "test":
            # the held-out battery: a plain {test_acc: ..., ...} dict
            for k, v in row.items():
                print(f"test {k} -> {v}")
        else:
            print(metric, "->", float(row[metric]))
    return 0


def cmd_baseline(args) -> int:
    from multimodalautoencoder_tpu_torch.baselines import (
        logistic_regression, neural_net, random_forest, svm)

    cls = {"svm": svm.SVMSweep, "rf": random_forest.RFSweep,
           "lr": logistic_regression.LRSweep,
           "nn": neural_net.NNSweep}[args.model]
    dl = _loader(args.filename, True, args, wanted_label=args.label,
                 labels_to_sign=(args.model == "svm"))
    extra = (dict(device=args.device, seed=args.seed)
             if args.model == "nn" else {})
    try:
        sweep = cls(dl, results_path=args.results_path, cont=args.cont,
                    check_test=args.check_test, num_cross_folds=args.folds,
                    wanted_label=args.label, **extra)
    except ImportError as e:
        raise SystemExit(f"baseline {args.model}: {e}") from e
    best, test = sweep.run()
    print(best)
    if test:
        print(test)
    return 0


def cmd_feature_select(args) -> int:
    from multimodalautoencoder_tpu_torch.data import feature_selection as fs

    try:
        out = fs.create_transformed_dataset(
            args.filename, args.transform, args.num_features,
            label=args.label, backend=args.backend,
            fill_missing=args.fill_missing, device=args.device,
            engine=args.engine)
    except ImportError as e:
        raise SystemExit(f"feature-select: {e}") from e
    print("wrote:", out)
    return 0


def cmd_jobs(args) -> int:
    from multimodalautoencoder_tpu_torch.utils import jobs

    results = jobs.run_jobs(args.job_file, minimum_seconds=args.min_seconds)
    return 0 if all(r.status != jobs.ERROR for r in results) else 1


def cmd_merge_shards(args) -> int:
    """After a --process-shard run: merge the ledger shards into one
    results CSV (parallel/multihost.py) and, where the processes exported
    slice winners, name the global best checkpoint."""
    from multimodalautoencoder_tpu_torch.parallel import multihost

    out = multihost.merge_ledger_shards(args.results_path, args.prefix,
                                        num_shards=args.num_shards)
    print("merged ledger:", out)
    if args.best_checkpoint:
        try:
            win = multihost.select_global_best_checkpoint(
                args.results_path, args.best_checkpoint,
                num_shards=args.num_shards)
            print("global best checkpoint:", win)
        except (FileNotFoundError, ValueError) as e:
            print(f"no global best checkpoint: {e}")
            return 1
    return 0


def _add_engine(p: argparse.ArgumentParser) -> None:
    p.add_argument("--engine", choices=("pandas", "native"),
                   default="pandas",
                   help="CSV reader: the port's own reader, which gives "
                        "pandas' floats ('pandas'), or the C++ parser of "
                        "csrc/csv_loader.cpp, correctly rounded")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--normalize-and-fill", action="store_true",
                   help="normalize + impute the raw CSV on load")
    p.add_argument("--normalization",
                   choices=("between_0_and_1", "z_score"),
                   default="between_0_and_1",
                   help="z_score only for 'baseline' (the reference "
                        "baseline CLIs' prep, comparison_algorithms/"
                        "svm.py:14,143-150)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (the sweeps: a "
                        "comma-separated list to split each bucket over)")
    _add_engine(p)


def _add_run_common(p: argparse.ArgumentParser) -> None:
    """Flags the sweeps and the baselines take."""
    p.add_argument("--results-path", default="results")
    p.add_argument("--continue", "--cont", dest="cont", action="store_true",
                   help="resume from a previous results CSV")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--check-test", action="store_true",
                   help="retrain the best setting on fold 0 and score it "
                        "on the held-out test set")


def _add_sweep_common(p: argparse.ArgumentParser) -> None:
    """Flags both sweep subcommands take."""
    p.add_argument("--backend", choices=("auto", "xla", "pallas"),
                   default="auto",
                   help="'auto' trains on the CUDA kernels where the shape "
                        "family allows and the device is a GPU, the plain "
                        "trainers otherwise; 'xla'/'pallas' force")
    p.add_argument("--process-shard", nargs=2, type=int, default=None,
                   metavar=("I", "N"),
                   help="sweep only the round-robin slice I of N (0-based)"
                        " and write a ledger shard; merge with "
                        "merge-shards")
    _add_run_common(p)
    p.add_argument("--save-best-params", action="store_true",
                   help="checkpoint the best setting's fold-0 parameters "
                        "at the end of the sweep (consumable by "
                        "fill/embed --checkpoint)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="multimodalautoencoder_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)
    p = sub.add_parser("sweep-mmae", help="MMAE hyperparameter grid search")
    p.add_argument("filename")
    p.add_argument("classification_filename", nargs="?", default=None)
    p.add_argument("--num-steps", type=int, default=15000)
    p.add_argument("--probe", default="device",
                   choices=("device", "device-exact", "svm", "none"),
                   help="embedding-quality probe: the on-device RFF ridge "
                        "(default), the exact kernel ridge, the host "
                        "sklearn SVC grid (needs scikit-learn), or none")
    _add_sweep_common(p)
    _add_common(p)
    p.set_defaults(fn=cmd_sweep_mmae)
    p = sub.add_parser("sweep-classification",
                       help="two-phase MMAE+classifier grid search")
    p.add_argument("mmae_filename")
    p.add_argument("classification_filename")
    p.add_argument("label", nargs="?", default=None)
    p.add_argument("--num-steps", type=int, default=15000)
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="matmul-operand dtype for phase-2 training "
                        "(accumulation and storage stay float32)")
    _add_sweep_common(p)
    _add_common(p)
    p.set_defaults(fn=cmd_sweep_classification)
    p = sub.add_parser("train", help="train one MMAE and checkpoint it")
    p.add_argument("filename")
    p.add_argument("--arch", type=int, nargs="+", default=[128, 64, 32])
    p.add_argument("--variational", action="store_true")
    p.add_argument("--num-steps", type=int, default=30000)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    _add_common(p)
    p.set_defaults(fn=cmd_train)
    for name, fn, hlp in (("fill", cmd_fill,
                           "fill missing modalities with reconstructions"),
                          ("embed", cmd_embed,
                           "export per-row embeddings")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("filename")
        p.add_argument("--checkpoint", required=True)
        _add_common(p)
        p.set_defaults(fn=fn)
    p = sub.add_parser("baseline", help="comparison-baseline grid search")
    p.add_argument("model", choices=("svm", "rf", "lr", "nn"))
    p.add_argument("filename")
    p.add_argument("label", nargs="?", default=None)
    _add_run_common(p)
    _add_common(p)
    p.set_defaults(fn=cmd_baseline)
    p = sub.add_parser("feature-select", help="PCA / SelectKBest dataset")
    p.add_argument("filename")
    p.add_argument("transform", choices=("pca", "skb"))
    p.add_argument("num_features", type=int)
    p.add_argument("--label", default=None)
    p.add_argument("--backend", choices=("sklearn", "jax"),
                   default="sklearn",
                   help="'sklearn': scikit-learn's PCA / SelectKBest on the "
                        "host; 'jax' (the JAX package's name): the port's "
                        "own path, the PCA's SVD on --device")
    p.add_argument("--fill-missing", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the 'jax' backend's SVD")
    _add_engine(p)
    p.set_defaults(fn=cmd_feature_select)
    p = sub.add_parser("jobs", help="run a 4-line-per-job batch file")
    p.add_argument("job_file")
    p.add_argument("--min-seconds", type=float, default=600)
    p.set_defaults(fn=cmd_jobs)
    p = sub.add_parser("merge-shards",
                       help="merge --process-shard ledger shards (and name "
                            "the global best checkpoint)")
    p.add_argument("results_path")
    p.add_argument("prefix",
                   help="ledger prefix, e.g. 'MMAE-acii' (the CSV name "
                        "without .shardIofN.csv)")
    p.add_argument("--num-shards", type=int, default=None,
                   help="shard generation (the ofN suffix); default: the "
                        "most recently written one")
    p.add_argument("--best-checkpoint", default=None, metavar="NAME",
                   help="also pick the global winner among "
                        "NAME.shardIofN-*.npz exports (e.g. 'best_mmae' or"
                        " 'best_mmae_cls')")
    p.set_defaults(fn=cmd_merge_shards)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
