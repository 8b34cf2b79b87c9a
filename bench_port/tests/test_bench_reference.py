"""The plain reference against the port's CPU twin at tiny sizes: on the
CPU the entries run the twin (``train_grid_kernel_reference``,
``train_cls_kernel_reference``), and the reference follows each bucket's
first window call to the last bit."""

import io
import json

import pytest

from bench_port import control, nojax, run, testing

CELLS = ("mmae_grid.sweep_mix", "cls_grid.phase2_wide")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return testing.make_tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_twin(tiny, cell):
    res = control.readings(cell, [5, 2 ** 31 + 11], [], root=tiny,
                           device="cpu", log=io.StringIO())
    for seed, numbers in res["program"].items():
        assert set(numbers) >= {"loss_gap", "grad_gap", "change_gap"}
        for name, value in numbers.items():
            assert value <= 1e-6, (seed, name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_its_result_line_last(tiny, cell):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", "4294967311",
                   "--seconds", "0.05"], root=tiny, device="cpu",
                  require_cuda=False, out=out, err=err)
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"train_inst_steps_per_s", "setup_s"}
    assert line["attempted"] == 3 * line["window"]["passes"]
    last = err.getvalue().strip().splitlines()[-len(line["check"]):]
    assert all(x.startswith("check ") for x in last)


def test_a_run_without_the_cells_device_prints_nothing(tiny):
    out, err = io.StringIO(), io.StringIO()
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                  root=tiny, out=out, err=err)
    assert rc == 2 and out.getvalue() == ""


def test_no_jax_compares_whole_top_level_names():
    assert nojax.forbidden_loaded(["multimodalautoencoder_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert nojax.forbidden_loaded(["jax.numpy", "multimodalautoencoder_tpu",
                                   "jaxlib.xla_client"]) == \
        ["jax", "jaxlib", "multimodalautoencoder_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.');"
            "import bench_port.run, bench_port.control, bench_port.judge;"
            "import bench_port.reference.phase1, bench_port.reference.phase2;"
            "import multimodalautoencoder_tpu_torch.parallel.grid_trainer;"
            "from bench_port import nojax; print(nojax.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=testing.REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_non_finite_reading_is_not_correct_and_prints_as_text():
    import math

    from bench_port import judge

    ok, shown = judge.verdict({"loss_gap": math.nan, "grad_gap": 1e-9},
                              {"loss_gap": {"limit": 1e-5},
                               "grad_gap": {"limit": 1e-6}})
    assert not ok
    assert json.loads(json.dumps(shown, allow_nan=False))["loss_gap"] == \
        {"value": "nan", "limit": 1e-5}
