"""Training loops as replayed CUDA graphs: the counterpart of the JAX
package's ``jax.jit`` of a ``lax.scan``.

The JAX package runs a whole single run as one compiled call
(``train/trainer.py:1-19``, ``models/neural_net.py:121-168``).  Run as a
Python loop, a step of the port is 150-270 small launches, and the host,
not the device, sets its pace.  On the card :func:`run` captures one step,
and one evaluation, as CUDA graphs and replays them, so each is one launch
from the host.

:func:`run` takes a step and an evaluation that work in place on tensors
at fixed addresses (the run's parameters, optimizer state, step counter
and data) and draw only from the run's generator:

- on CPU tensors it calls them in the loop's order (:func:`eager_loop`);
- on CUDA tensors (:func:`graphed_loop`) the first call of each runs
  eagerly on a side stream.  This is the warm-up: it creates the library
  handles, loads the kernels and raises ``fused_dense``'s shared-memory
  limit, so that nothing a capture refuses happens under capture.  It is
  also the run's own first step or evaluation, so the run launches what
  the eager loop launches.  The second call captures the function
  (:class:`StepGraph`) and every later call replays it.  The generator is
  registered with each graph, so a replay draws what an eager call would
  have drawn.  A failure to capture or replay raises: nothing falls back
  to the eager loop on the card.

Tensors a captured function allocates live in its graph's private memory
pool and are overwritten by the next replay: the evaluation's results are
copied out after each replay.

Within :func:`eager_route`, :func:`run` calls the functions in the eager
loop on the card too: the control that ``chip_smoke.py`` and the ``cuda``
tests hold the graphed route against.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List

import torch

from multimodalautoencoder_tpu_torch.ops.cuda_library import NvccLibrary


class StepGraph:
    """``fn`` captured once as a CUDA graph on ``stream``, replayed on the
    current stream.  ``out`` is what ``fn`` returned during the capture:
    tensors that each replay overwrites.  The kernel libraries count the
    launches recorded into the graph as ``captured``
    (``NvccLibrary.count``); each replay adds them to ``launches``.

    The capture is ordered after everything queued on the current stream
    and before what comes next on it: before it starts capturing,
    ``capture_begin`` fills the generator's graph-wide seed and offset
    with launches on ``stream``, and replays of the run's other graph,
    still queued on the current stream, read them."""

    def __init__(self, fn: Callable, generator: torch.Generator,
                 stream: torch.cuda.Stream):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        before = {lib: lib.captured for lib in NvccLibrary.instances}
        current = torch.cuda.current_stream()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.graph.capture_begin()
            try:
                self.out = fn()
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass   # the capture is invalid; the first error stands
                raise
            self.graph.capture_end()
        current.wait_stream(stream)
        self.held = [(lib, lib.captured - before.get(lib, 0))
                     for lib in list(NvccLibrary.instances)]
        self.held = [(lib, n) for lib, n in self.held if n]

    def replay(self) -> None:
        self.graph.replay()
        for lib, n in self.held:
            lib.count(n)


def eager_loop(step: Callable, evaluate: Callable, num_steps: int,
               eval_steps: Iterable[int]) -> List[torch.Tensor]:
    """``num_steps`` calls of ``step``, with a call of ``evaluate`` before
    step ``s`` for each ``s`` in ``eval_steps`` (``s == num_steps``: after
    the last); returns what the evaluations returned."""
    evals = set(eval_steps)
    out = []
    for s in range(num_steps + 1):
        if s in evals:
            out.append(evaluate())
        if s < num_steps:
            step()
    return out


def graphed_loop(step: Callable, evaluate: Callable, num_steps: int,
                 eval_steps: Iterable[int],
                 generator: torch.Generator) -> List[torch.Tensor]:
    """:func:`eager_loop` on the card: each function's first call eager on
    a side stream, its second captured, every later one replayed."""
    device = generator.device
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    graphs = {}

    def call(fn):
        g = graphs.get(fn)
        if g is None:
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = fn()
            main.wait_stream(side)
            graphs[fn] = False
            return out
        if g is False:
            g = graphs[fn] = StepGraph(fn, generator, side)
        g.replay()
        return g.out

    evals = set(eval_steps)
    out = []
    with torch.cuda.device(device):
        for s in range(num_steps + 1):
            if s in evals:
                out.append(call(evaluate).clone())
            if s < num_steps:
                call(step)
    return out


_EAGER = [False]


@contextlib.contextmanager
def eager_route():
    """Within: :func:`run` calls the step and the evaluation in the eager
    loop whatever the device."""
    before = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = before


def run(step: Callable, evaluate: Callable, num_steps: int,
        eval_steps: Iterable[int], generator: torch.Generator,
        device) -> List[torch.Tensor]:
    """:func:`eager_loop` on CPU tensors (and within
    :func:`eager_route`), :func:`graphed_loop` on CUDA tensors
    (``device`` is the data's).  The run's draws must come from
    ``generator`` alone, on ``device``."""
    device = torch.device(device)
    if device.type == "cpu" or _EAGER[0]:
        return eager_loop(step, evaluate, num_steps, eval_steps)
    if device.type != "cuda":
        raise ValueError(f"training runs on cuda or cpu, not {device}")
    if generator.device.type != "cuda":
        raise ValueError(f"the run's generator lies on {generator.device}; "
                         f"a run on {device} draws on the card")
    return graphed_loop(step, evaluate, num_steps, eval_steps, generator)
