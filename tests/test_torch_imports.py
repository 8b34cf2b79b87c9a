"""The port stands alone: it imports neither jax nor the JAX package, and
neither the serve path nor the training, sweep, probe, baseline, data and
demo paths import pandas or scikit-learn.  scikit-learn is imported only
inside the functions that need it (the SVM, RF and LR baselines, the SVM
probe, feature selection's sklearn backend), never at a module's top.

The import check runs in a fresh interpreter, because this suite's
conftest has already imported jax into the test process.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "multimodalautoencoder_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "multimodalautoencoder_tpu", "pandas",
             "sklearn")
# imported inside a function at most, where a host estimator needs it
LAZY_ONLY = ("sklearn",)


def _sources():
    for d, _, names in os.walk(PORT):
        for n in sorted(names):
            if n.endswith(".py"):
                yield os.path.join(d, n)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path, module_level: bool):
    """The top-level package of every import in the file, or only of those
    at module level."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    nodes = tree.body if module_level else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_forbidden(path):
    anywhere = set(FORBIDDEN) - set(LAZY_ONLY)
    bad = sorted((set(_imports(path, False)) & anywhere)
                 | (set(_imports(path, True)) & set(LAZY_ONLY)))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_serve_path_import_pulls_in_no_jax_pandas_or_sklearn():
    code = (
        "import sys\n"
        "import multimodalautoencoder_tpu_torch.cli\n"
        "import multimodalautoencoder_tpu_torch.tools.files\n"
        "import multimodalautoencoder_tpu_torch.data.synthetic\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_path_import_pulls_in_no_jax_pandas_or_sklearn():
    code = (
        "import sys\n"
        "import multimodalautoencoder_tpu_torch.parallel.grid_trainer\n"
        "import multimodalautoencoder_tpu_torch.ops.train_kernels\n"
        "import multimodalautoencoder_tpu_torch.sweep.grid\n"
        "import multimodalautoencoder_tpu_torch.ops.cls_train_kernels\n"
        "import multimodalautoencoder_tpu_torch.ops.metrics\n"
        "import multimodalautoencoder_tpu_torch.sweep.engine\n"
        "import multimodalautoencoder_tpu_torch.sweep.wrappers\n"
        "import multimodalautoencoder_tpu_torch.utils.helpers\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_mmae_sweep_path_import_pulls_in_no_jax_pandas_or_sklearn():
    """The MMAE sweep's modules: the deep kernels, the probe and the
    bandwidth probe."""
    code = (
        "import sys\n"
        "import multimodalautoencoder_tpu_torch.ops.train_deep_kernels\n"
        "import multimodalautoencoder_tpu_torch.sweep.probe\n"
        "import multimodalautoencoder_tpu_torch.tools.hbm_bench\n"
        "from multimodalautoencoder_tpu_torch.sweep.wrappers import "
        "MMAESweep\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_single_run_path_import_pulls_in_no_jax_pandas_or_sklearn():
    """The single-run trainer, the facade, the plots and the CLI: none of
    them loads jax, the JAX package, pandas or scikit-learn."""
    code = (
        "import sys\n"
        "import multimodalautoencoder_tpu_torch.api\n"
        "import multimodalautoencoder_tpu_torch.train.trainer\n"
        "import multimodalautoencoder_tpu_torch.train.checkpoint\n"
        "import multimodalautoencoder_tpu_torch.utils.plotting\n"
        "import multimodalautoencoder_tpu_torch.ops.masking\n"
        "import multimodalautoencoder_tpu_torch.cli\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_baseline_and_data_paths_import_no_jax_pandas_or_sklearn():
    """The comparison baselines, the NN model, feature selection, the
    native CSV reader and the probe-parity harness: importing them loads
    no jax, JAX package, pandas or scikit-learn."""
    code = (
        "import sys\n"
        "import multimodalautoencoder_tpu_torch.baselines.common\n"
        "import multimodalautoencoder_tpu_torch.baselines.svm\n"
        "import multimodalautoencoder_tpu_torch.baselines.random_forest\n"
        "import multimodalautoencoder_tpu_torch.baselines.logistic_regression"
        "\n"
        "import multimodalautoencoder_tpu_torch.baselines.neural_net\n"
        "import multimodalautoencoder_tpu_torch.models.neural_net\n"
        "import multimodalautoencoder_tpu_torch.data.feature_selection\n"
        "import multimodalautoencoder_tpu_torch.data.fast_csv\n"
        "import multimodalautoencoder_tpu_torch.sweep.probe_parity\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_demo_and_wheel_paths_import_no_jax_pandas_or_sklearn():
    """The end-to-end demo and what an installed wheel resolves at first
    use (the build directory, the multi-process helpers, the wheel
    check): importing them
    loads no jax, JAX package, pandas or scikit-learn."""
    code = (
        "import sys\n"
        "import multimodalautoencoder_tpu_torch.examples.acii_pipeline\n"
        "import multimodalautoencoder_tpu_torch.ops.cuda_library as cl\n"
        "import multimodalautoencoder_tpu_torch.parallel.multihost\n"
        "import multimodalautoencoder_tpu_torch.tools.multihost_sweep\n"
        "import multimodalautoencoder_tpu_torch.tools.wheel_check\n"
        "cl.build_dir()\n"
        f"bad = [m for m in {FORBIDDEN!r} if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a GPU the smoke exits non-zero and prints no result line,
    from the checkout and from a directory holding only the script."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
