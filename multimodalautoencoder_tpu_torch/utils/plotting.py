"""Matplotlib views of a run (reference: multimodal_autoencoder.py :952-985
training curves, :1103-1133 reconstruction view).

Counterpart of ``multimodalautoencoder_tpu/utils/plotting.py``.  Every
function takes ``show`` / ``save_path``, so it works headless (the
reference always calls ``plt.show()``).  Matplotlib is imported inside each
call, with the Agg backend when there is no display; where it is not
installed the call raises an ``ImportError`` that names it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plotting needs matplotlib, which is not "
                          "installed") from exc
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, fig, show: bool, save_path: Optional[str]):
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)
    return fig


def plot_training_progress(train_loss: Sequence[float],
                           val_loss: Sequence[float],
                           record_every_nth: int = 50,
                           show: bool = True,
                           save_path: Optional[str] = None):
    """Train/val loss curves (:952-963)."""
    plt = _plt()
    x = [record_every_nth * i for i in range(len(train_loss))]
    fig = plt.figure()
    plt.plot(x, list(train_loss))
    plt.plot(x, list(val_loss))
    plt.legend(["Train", "Validation"], loc="best")
    plt.xlabel("Training step")
    plt.ylabel("Loss")
    return _finish(plt, fig, show, save_path)


def plot_classification_training_progress(
        train_acc, val_acc, cls_train_loss, cls_val_loss,
        record_every_nth: int = 50, show: bool = True,
        save_path: Optional[str] = None):
    """Accuracy and classification-loss curves (:965-985)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, (tr, va), ylabel in (
            (axes[0], (train_acc, val_acc), "Accuracy"),
            (axes[1], (cls_train_loss, cls_val_loss),
             "Classification loss")):
        x = [record_every_nth * i for i in range(len(tr))]
        ax.plot(x, list(tr))
        ax.plot(x, list(va))
        ax.legend(["Train", "Validation"], loc="best")
        ax.set_xlabel("Training step")
        ax.set_ylabel(ylabel)
    return _finish(plt, fig, show, save_path)


def view_reconstruction(x: np.ndarray, recon: np.ndarray,
                        noisy: Optional[np.ndarray] = None,
                        show: bool = True,
                        save_path: Optional[str] = None):
    """Original / noisy / reconstructed feature-vector overlay
    (:1103-1133)."""
    plt = _plt()
    fig = plt.figure()
    legend = []
    if noisy is not None:
        plt.plot(np.ravel(noisy))
        legend.append("Noisy X")
    plt.plot(np.ravel(x))
    legend.append("X")
    plt.plot(np.ravel(recon), c="r")
    legend.append("X'")
    plt.legend(legend, loc="best")
    return _finish(plt, fig, show, save_path)


def plot_filled_row(x: np.ndarray, recon: np.ndarray, filled: np.ndarray,
                    show: bool = True, save_path: Optional[str] = None):
    """Original / reconstructed / filled overlay: the debug plot inside
    fill_df_with_reconstruction (data_funcs.py:339-355)."""
    plt = _plt()
    fig = plt.figure()
    plt.plot(np.ravel(x))
    plt.plot(np.ravel(recon))
    plt.plot(np.ravel(filled), c="r")
    plt.legend(["Original X", "Reconstructed X", "Filled X"], loc="best")
    return _finish(plt, fig, show, save_path)
