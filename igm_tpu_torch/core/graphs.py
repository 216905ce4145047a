"""CUDA graphs for the port's steps: the counterpart of ``jax.jit`` on a
train step or a denoiser call.

``igm_tpu`` compiles a train step once and dispatches it as one program
(``jax.jit(train_step)``; ``lax.scan`` chains K of them, and every sampler
chain is one scan).  Eager PyTorch launches each of a step's ~1,900 kernels
from the host.  :class:`StepGraph` captures a step into one
``torch.cuda.CUDAGraph`` and replays it:

- its first call copies the inputs into static buffers and runs the
  callable eagerly on a side stream (the warm-up: every kernel's first
  launch, with its one-time set-up such as the dynamic shared-memory
  attribute, happens here, outside the capture), and that run is this
  call's result; then it captures the callable on the static buffers into
  a graph with a memory pool of its own;
- each later call copies its inputs into the static buffers, replays the
  graph, and returns copies of the static outputs, so that a result read
  later (metrics read one step late) is not overwritten by the next launch;
- the training generator is registered with the graph
  (``CUDAGraph.register_generator_state``): a replay reads the generator's
  current seed and offset and advances the offset as the eager draws would,
  so replayed draws continue the generator's stream exactly;
- the kernel wrappers count launches in Python (``ops/*.py``
  ``launches``), and the tracing registry counts device work such as
  collective calls and bytes (``core/trace.py``, ``count(..., work=True)``),
  which runs once at capture and not at a replay: the counts the capture
  moved are taken back, and added again at every replay, so the counters
  go on meaning work done;
- spans (``core/trace.py``): ``graphs.capture`` the warm-up and the capture
  (counted in ``graphs.captures``), ``graphs.replay`` a replay with its
  copies in and out, ``graphs.launch`` the launch alone, which returns
  when the device's queue has room (back-pressure shows there);
- the cycle collector does not run during a capture: a graph destroyed
  while another is being captured invalidates that capture.

The callable must read and write device state only through tensors that
outlive the graph (parameters, optimizer state, buffers): a replay
re-runs its kernels on the same addresses.  Whatever it does on the host
(a step counter, a module's train flag) runs once at capture; the caller
puts that right.  A capture or replay failure raises: nothing falls back
to the eager step.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from . import trace


def launch_counters() -> tuple:
    """Every kernel wrapper that counts its launches."""
    from ..ops import dropout_attention as da
    from ..ops.fused_block import fused_block_fwd
    from ..ops.groupnorm import group_norm_mish, group_norm_mish_bwd
    from ..ops.linear_attention import linear_attention_flat, linear_attention_flat_bwd
    from ..ops.vq import nearest_codebook
    return (group_norm_mish, group_norm_mish_bwd, linear_attention_flat,
            linear_attention_flat_bwd, nearest_codebook, da.dropout_attention_fwd,
            da.dropout_attention_dq, da.dropout_attention_dkv, fused_block_fwd)


def work_counts() -> Dict[Any, float]:
    """Every count of device work: each kernel wrapper's launches, and the
    registry's work counters by name."""
    counts: Dict[Any, float] = {c: c.launches for c in launch_counters()}
    counts.update(trace.work_counts())
    return counts


def _add_work(key: Any, n: float) -> None:
    if isinstance(key, str):
        trace.count(key, n, work=True)
    else:
        key.launches += n


def _map(fn: Callable, out: Any) -> Any:
    """``fn`` applied to the tensors of a tensor, or of a dict of tensors."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    raise TypeError(f"a captured step returns a tensor or a dict of tensors, "
                    f"got {type(out).__name__}")


class StepGraph:
    """``fn(*inputs)`` as a CUDA graph: eager (and the warm-up) at the first
    call, replayed after.  ``generators`` are registered with the graph;
    ``capture_context()``, when given, is entered around the capture only."""

    def __init__(self, fn: Callable[..., Any],
                 generators: Sequence[torch.Generator] = (),
                 capture_context: Optional[Callable[[], Any]] = None):
        self.fn = fn
        self.generators = tuple(generators)
        self.capture_context = capture_context or contextlib.nullcontext
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        self.outputs: Any = None
        self.deltas: Dict[Any, int] = {}

    def __call__(self, *inputs: torch.Tensor) -> Any:
        if self.graph is None:
            return self._warm_up_and_capture(inputs)
        return self._replay(inputs)

    def _warm_up_and_capture(self, inputs) -> Any:
        if not all(t.is_cuda for t in inputs):
            raise ValueError("StepGraph takes CUDA tensors")
        trace.count("graphs.captures")
        with trace.span("graphs.capture"):
            return self._capture(inputs)

    def _capture(self, inputs) -> Any:
        current = torch.cuda.current_stream()
        self.inputs = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = self.fn(*self.inputs)
        current.wait_stream(side)
        _map(lambda t: t.record_stream(current), result)

        before = work_counts()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        # a graph dropped earlier may sit in a reference cycle (its callable
        # holds its model): the cycle collector destroys it whenever it
        # runs, and a graph destroyed inside this capture invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self.capture_context(), torch.cuda.graph(graph,
                                                          capture_error_mode="thread_local"):
                self.outputs = self.fn(*self.inputs)
        finally:
            if collecting:
                gc.enable()
            # nothing ran at capture: the work it counted is counted at each
            # replay, and only the counts it moved are walked there
            for key, n in work_counts().items():
                moved = n - before.get(key, 0)
                if moved:
                    self.deltas[key] = moved
                    _add_work(key, -moved)
        self.graph = graph
        return result

    def _replay(self, inputs) -> Any:
        if len(inputs) != len(self.inputs):
            raise ValueError(f"StepGraph captured {len(self.inputs)} inputs, got {len(inputs)}")
        with trace.span("graphs.replay"):
            for static, t in zip(self.inputs, inputs):
                if t is not static:
                    static.copy_(t)
            with trace.span("graphs.launch"):
                self.graph.replay()
            for key, n in self.deltas.items():
                _add_work(key, n)
            return _map(torch.clone, self.outputs)
