"""Step timing, profiling and metrics (counterpart of ``lycoris_tpu/observability.py``).

- :class:`StepTimer`: step time with an EMA and steps/s; it waits for the
  card only every ``sync_every`` steps, so the host runs ahead between.
- :func:`trace`: a ``torch.profiler`` window (CPU, and the card's kernels
  where there is one) written as a Chrome trace.
- :func:`span`: a named range of the program, a ``user_annotation`` in
  any profiler trace that records CPU activity (:func:`trace`'s included),
  on the same clock as the card's kernels; with no profiler running it
  costs one check and makes nothing. The spans:

  - ``lycoris.forward``: a ``DiffusionTrainer`` step's noise, timestep and
    drop-seed draws, premerge's merges, the model's forward and the loss;
  - ``lycoris.backward``: the step's ``loss.backward()`` and the release of
    its graph (autograd's ops run on its own threads, inside the span's
    time);
  - ``lycoris.all_reduce``: the gradients' all-reduce, under a mesh;
  - ``lycoris.clip``: the global-norm clip, with ``max_grad_norm``;
  - ``lycoris.optimizer``: the schedule's lr and ``optimizer.step()``;
  - ``lycoris.max_norm``: max-norm, with ``scale_weight_norms``;
  - ``lycoris.merge``: one layer's W + dW, wherever the port forms it (the
    merged forward, ``premerged``, ``merge_to`` and ``onfly_merge``, the
    factored forward and its recompute in the factored backward);
  - ``lycoris.rope``: one application of Wan's 3-D rotary positions to q
    or k (``models/wan.rope3d``), in the forward and in a checkpointed
    block's recompute.

  The trainer's phases are siblings and cover its step; a merge or a rope
  nests in the phase that runs it.
- :class:`MetricLogger`: the JSONL metrics file of the JAX package (one
  record a line: ``step``, ``time`` and the metrics).
- :func:`log_compile_time`: the first call's time (kernel builds, cuDNN
  autotuning, the allocator's first blocks), under the JAX package's name.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from .logging import logger


def _sync(result) -> None:
    """Wait for the card ``result`` (a tensor, or a tuple/list/dict of them)
    lives on, if any."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


_NULL_SPAN = contextlib.nullcontext()


def span(name: str):
    """The context of a program span ``name``: ``record_function(name)``
    while a profiler runs, else one shared null context (no RecordFunction
    is made: a span costs well under a microsecond then)."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL_SPAN
    return torch.profiler.record_function(name)


class StepTimer:
    """EMA step timing that lets the host run ahead between syncs."""

    def __init__(self, ema: float = 0.9, sync_every: int = 10):
        self.ema = ema
        self.sync_every = sync_every
        self._t = None
        self._avg = None
        self._steps = 0

    def step(self, result=None):
        """Call once per train step, passing any tensor of the step's result
        to wait for every ``sync_every`` steps."""
        self._steps += 1
        if self._steps % self.sync_every:
            return self._avg
        if result is not None:
            _sync(result)
        now = time.perf_counter()
        if self._t is not None:
            dt = (now - self._t) / self.sync_every
            self._avg = dt if self._avg is None else self.ema * self._avg + (1 - self.ema) * dt
        self._t = now
        return self._avg

    @property
    def steps_per_sec(self):
        return None if not self._avg else 1.0 / self._avg


@contextlib.contextmanager
def trace(logdir: str, with_host: bool = False):
    """Profile the steps run inside the block into ``logdir/trace.json``
    (Chrome trace format); ``with_host`` also records the Python call stacks."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=with_host) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


class MetricLogger:
    """Append-only JSONL metrics file + a stdout line every ``stdout_every`` records."""

    def __init__(self, path: str | None = None, stdout_every: int = 50):
        self.path = path
        self.stdout_every = stdout_every
        self._n = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **{k: _to_py(v) for k, v in metrics.items()}}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        self._n += 1
        if self._n % self.stdout_every == 0:
            logger.info(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                                 for k, v in rec.items()))

    def close(self):
        if self._f:
            self._f.close()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def log_compile_time(fn, *args, label: str = "step", **kwargs):
    """Run fn once, report (result, seconds of the first call, the card
    waited for)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    dt = time.perf_counter() - t0
    logger.info(f"{label}: first call (kernel builds + run) took {dt:.1f}s")
    return out, dt
