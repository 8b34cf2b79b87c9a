"""The check's control and faults at a size a test run can hold: with the
cells' own limits, each comes out not correct.

- the control: the reference in the program's place with its products in
  TF32, the nearest precision below the configurations' float32;
- a step that returns its state unchanged;
- half of every batch left out, the mean taken over the rest (the rows'
  second half replaced by the first);
- an answer altered where it is produced (one objective, one prediction).

Each fault is planted in the program's CPU twin, which the entries run
on the CPU, and a whole run is driven past the harness's look for a
chip.  (The exchange between chips does not exist in one-chip cells.)"""

import io
import json

import pytest
import torch

from bench_port import control, judge, run, testing

CELLS = ("mmae_grid.sweep_mix", "cls_grid.phase2_wide")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return testing.make_tiny_root(str(tmp_path_factory.mktemp("tiny")))


def limits(tiny, cell):
    return run.read_json(f"{tiny}/bench_port/limits/{cell}.json")["numbers"]


def run_line(tiny, cell, seed=77):
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.05"], root=tiny, device="cpu", require_cuda=False,
                  out=out, err=io.StringIO())
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def halve(batch_fn):
    """``batch_fn`` with each batch's second half replaced by its first."""
    def wrapped(run_state, step):
        parts = batch_fn(run_state, step)
        half = parts[0].shape[1] // 2
        out = []
        for t in parts:
            t = t.clone()
            t[:, half:2 * half] = t[:, :half]
            out.append(t)
        return tuple(out)
    return wrapped


def plant(monkeypatch, cell, fault):
    from multimodalautoencoder_tpu_torch.ops import cls_train_kernels as ck
    from multimodalautoencoder_tpu_torch.ops import train_kernels as tk

    phase1 = cell == CELLS[0]
    if fault == "unchanged":
        name = ("train_grid_kernel_reference" if phase1
                else "train_cls_kernel_reference")
        monkeypatch.setattr(tk if phase1 else ck, name,
                            lambda run_state, first, n: None)
    elif fault == "half_batch":
        mod, name = (tk, "sample_batch") if phase1 else \
            (ck, "sample_cls_batch")
        monkeypatch.setattr(mod, name, halve(getattr(mod, name)))
    elif fault == "answer" and phase1:
        real = tk.noisy_val_losses

        def altered(*a, **k):
            out = real(*a, **k).clone()
            out[0, 0] *= 1.001
            return out
        monkeypatch.setattr(tk, "noisy_val_losses", altered)
    elif fault == "answer":
        real = ck.val_predictions

        def flipped(*a, **k):
            out = real(*a, **k).clone()
            out[0, 0, 0, 0] = 1 - out[0, 0, 0, 0]
            return out
        monkeypatch.setattr(ck, "val_predictions", flipped)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    assert run_line(tiny, cell)["correct"] is True


@pytest.mark.parametrize("fault", ("unchanged", "half_batch", "answer"))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    plant(monkeypatch, cell, fault)
    line = run_line(tiny, cell)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tiny, cell):
    res = control.readings(cell, [], [91, 92, 93], root=tiny, device="cpu",
                           log=io.StringIO())
    for kind in ("control", "half_batch"):
        for seed, numbers in res[kind].items():
            ok, shown = judge.verdict(numbers, limits(tiny, cell))
            assert not ok, (kind, seed, shown)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = io.StringIO()
    rc = run.main(["--workload", cell, "--seed", "4294967313",
                   "--seconds", "1"], out=out, err=io.StringIO())
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
