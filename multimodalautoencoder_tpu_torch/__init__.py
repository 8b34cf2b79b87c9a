"""multimodalautoencoder_tpu_torch — the PyTorch and CUDA port of
``multimodalautoencoder_tpu``.

The JAX package beside it is the reference this port is held against.
Module paths mirror it, and each module's docstring names its counterpart.
The serve path: a checkpoint is loaded (``train/checkpoint.py``) and a
CSV is filled or embedded (``tools/files.py``, ``cli.py fill|embed``)
through the model forward (``models/mmae.py``), whose dense layers run the
hand-written CUDA kernel of ``ops/dense_kernels.py`` when the config sets
``use_pallas``.  Grid training: CV folds (``data/loader.py``) and the
grid's shape buckets (``sweep/grid.py``) train through
``parallel/grid_trainer.py``, on the hand-written CUDA training kernels or
a plain autograd trainer, under the two sweeps (``sweep/wrappers.py``).
Single-run training: ``train/trainer.py`` and the
``api.MultimodalAutoencoder`` facade (``cli.py train``).

Importing the package imports neither jax nor pandas.
"""

__version__ = "0.1.0"

from multimodalautoencoder_tpu_torch.config import MMAEConfig, TrainConfig

__all__ = ["MMAEConfig", "TrainConfig", "__version__"]
