"""Device-resident loops: one iteration captured as a CUDA graph and replayed.

The reference runs EM's convergence loop in ``lax.while_loop`` and the CGS
sweeps in ``lax.scan``: one device program that the host starts and reads
(``bammmotif2_tpu/refinement/multi.py::batched_while_loop``,
``gibbs.py::gibbs_optimize`` and its ``lru_cache``d ``_batched_gibbs_loop``).
Here a loop's iteration is a ``body(state, gens)`` that reads its inputs and
updates its state in place (``copy_`` into the state's buffers).  ``Loop``
runs it:

  * on a CUDA device, when ``enabled``: the state and inputs live in static
    buffers.  The first iteration runs eagerly, as a real iteration, on a
    capture stream of the device (it warms the kernel launchers' cached
    queries and creates ``ops.cuda_counts.workspace``'s buffers for that
    stream); then the body is captured once as a ``torch.cuda.CUDAGraph``,
    the chains' generators registered with it, and each further iteration
    is one replay.  Captured loops stay in a small cache keyed by the loop's
    name, its constants and its tensors' shapes, the counterpart of the
    reference's ``lru_cache``: a later call with the same key (the next
    group of equal shape, the next FDR fold) copies its inputs and initial
    state into the static buffers and replays at once;
  * elsewhere (the CPU, a gloo mesh, ``graphs=False``): the same body runs
    eagerly on the caller's tensors, so the CPU tests cover the code that
    the graph captures.

A body need not be a loop's: the FDR group program
(``evaluation/fdr.py::_tail``) runs its fold tail as one step a fold, the
fold's index and model copied into the state between steps, its outputs
(``outputs``) made once per capture.

The rule (``enabled``): graphs iff the device is CUDA and there is no mesh
or the mesh's data group runs NCCL, whose in-place all-reduce joins the
graph.  A gloo group stages CUDA tensors through host memory
(``parallel.mesh.all_reduce``) and cannot be captured.  The rule is chosen
before any capture; a capture that fails raises ``CaptureError`` naming the
loop and the operation, and nothing runs the eager loop instead.

Launch counters (``ops.cuda_*``'s ``.launches``) count launches: the
wrappers add one when the body is captured, which launches nothing, so the
capture's additions are taken back and added once per replay.
"""

from __future__ import annotations

import collections
import os
import time
import traceback

import torch

CACHE_SIZE = 8  # captured loops kept (each holds its static buffers and graph pool)

# key -> _Captured, least recently used first
_CACHE: collections.OrderedDict = collections.OrderedDict()
_STREAMS: dict = {}  # device index -> the capture stream


class CaptureError(RuntimeError):
    """A loop's iteration could not be captured as a CUDA graph."""


def enabled(device, mesh=None) -> bool:
    """Whether a loop on ``device`` (sharded over ``mesh``, if any) runs as
    a CUDA graph: the device is CUDA, and there is no mesh or its data
    group's backend is NCCL."""
    if torch.device(device).type != "cuda":
        return False
    if mesh is None:
        return True
    import torch.distributed as dist

    return dist.get_backend(mesh.data_group) == "nccl"


def counted() -> tuple:
    """The kernel wrappers whose ``.launches`` count launches."""
    from bammmotif2_tpu_torch.ops import cuda_counts, cuda_em, cuda_flat, cuda_scores

    return (cuda_em.em_counts_multi, cuda_scores.window_scores_multi,
            cuda_counts.counts_from_r_multi, cuda_flat.em_counts, cuda_flat.window_scores,
            cuda_flat.counts_from_r)


def clear() -> None:
    """Drop every captured loop."""
    _CACHE.clear()


def stats() -> list:
    """One dict a cached loop: its name, capture ms, calls (the capture's
    and later hits) and replays."""
    return [{"name": c.name, "capture_ms": c.capture_ms, "calls": c.calls,
             "replays": c.replays} for c in _CACHE.values()]


def split(data: dict) -> tuple:
    """(tensors, constants) of a data dict (``refinement.em.prepare_data``,
    a shard of ``parallel.mesh.shard_em_data``): the tensors by name, for a
    loop's ``inputs``, and the other entries (a shard's row bounds) as a
    sorted tuple, for its ``key``."""
    tensors = {k: t for k, t in data.items() if isinstance(t, torch.Tensor)}
    return tensors, tuple(sorted((k, x) for k, x in data.items() if k not in tensors))


def _signature(x):
    """Shapes and dtypes of a tensor, a tuple of them or a dict of either."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    return tuple(_signature(t) for t in x)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    else:
        for t in (x.values() if isinstance(x, dict) else x):
            yield from _tensors(t)


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _where(err: BaseException) -> str:
    """The innermost line of ``err``'s traceback outside torch and this
    module: the operation of the loop's body that failed."""
    skip = (os.path.dirname(os.path.abspath(torch.__file__)) + os.sep, os.path.abspath(__file__))
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not os.path.abspath(f.filename).startswith(skip)]
    if not frames:
        return "the end of the capture"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} ({f.line})"


def _with_outputs(state: dict, outputs: dict) -> dict:
    """``state`` itself, or with ``outputs`` made beside it."""
    return {**state, **{k: make() for k, make in outputs.items()}} if outputs else state


class _Captured:
    """A cached loop: static state and inputs, registered generators and the
    graph of one iteration, with the launches one iteration makes."""

    def __init__(self, name, state, inputs, gens, mesh):
        self.name, self.state, self.inputs, self.gens = name, state, inputs, gens
        self.mesh = mesh  # pinned: the key holds its id
        self.graph = None
        self.per_iteration: dict = {}
        self.capture_ms = 0.0
        self.calls = 1
        self.replays = 0


class Loop:
    """One run of a loop's iteration ``body(state, gens)``.

    ``state``: name -> tensor or tuple of tensors, the loop's state: fresh
    tensors that the loop owns and updates.  ``inputs``: name -> tensor,
    what the body reads and never writes; the body reads them through this
    dict, whose values the loop replaces by its static copies.  ``gens``:
    the chains' generators the body draws from.  ``key``: hashable, the
    body's constants; with the loop's name, the device, the mesh and the
    tensors' shapes and dtypes it decides which captured graph a call
    reuses.

    ``outputs``: name -> a function of no arguments making a state tensor
    that the body writes whole before it reads it (a fold's scores, where
    the body is not a loop but a step run once per fold): it is made where
    no captured loop of the key has it, and never copied in, so its shape
    must follow from ``key`` and the other tensors' shapes.

    After construction read the state from ``.state`` (the static buffers
    when graphed: copy out what must outlive the next loop of the same key)
    and call ``run(n)`` for n iterations.  A captured graph keeps the
    generators of the call that captured it; a later call of its key lends
    them its generators' state, and used as a context manager the loop
    hands that state back advanced as an eager loop leaves it.
    """

    def __init__(self, name: str, key, state: dict, inputs: dict, body, *, gens=(),
                 outputs=None, mesh=None, graphs: bool = True):
        self.name, self._body = name, body
        self.device = next(_tensors(state)).device
        self._caller_gens = list(gens)
        self._entry = None
        outputs = outputs or {}
        self.state, self.gens = state, self._caller_gens
        if not (graphs and enabled(self.device, mesh)):
            self.state = _with_outputs(state, outputs)
            return
        self._key = (name, key, str(self.device), _signature(state), _signature(inputs),
                     tuple(sorted(outputs)), len(self._caller_gens),
                     None if mesh is None else id(mesh))
        entry = _CACHE.get(self._key)
        if entry is None:
            entry = _Captured(name, _with_outputs(state, outputs),
                              {k: t.clone() for k, t in inputs.items()}, self._caller_gens,
                              mesh)
        else:
            _CACHE.move_to_end(self._key)
            entry.calls += 1
            for k, t in state.items():  # the outputs are not in it
                _copy_into(entry.state[k], t)
            for k, t in inputs.items():
                entry.inputs[k].copy_(t)
            for cached, g in zip(entry.gens, self._caller_gens):
                cached.set_state(g.get_state())
        inputs.update(entry.inputs)
        self._entry, self.state, self.gens = entry, entry.state, entry.gens

    @property
    def graphed(self) -> bool:
        return self._entry is not None

    def __enter__(self) -> "Loop":
        return self

    def __exit__(self, *exc) -> None:
        for cached, g in zip(self.gens, self._caller_gens):
            if cached is not g:
                g.set_state(cached.get_state())

    def run(self, n: int) -> None:
        """n iterations: eager, or graphed (a new key's first iteration runs
        eagerly and is then captured; the rest replay)."""
        if n <= 0:
            return
        entry = self._entry
        if entry is None:
            for _ in range(n):
                self._body(self.state, self.gens)
            return
        if entry.graph is None:
            self._warm_up_and_capture(entry)
            n -= 1
        for _ in range(n):
            entry.graph.replay()
        entry.replays += n
        for fn, d in entry.per_iteration.items():
            fn.launches += d * n

    def _warm_up_and_capture(self, entry: _Captured) -> None:
        stream = _STREAMS.get(self.device.index)
        if stream is None:
            stream = _STREAMS[self.device.index] = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        fns = counted()
        failed = None
        with torch.cuda.stream(stream):
            self._body(entry.state, entry.gens)  # a real iteration, counted
            before = [fn.launches for fn in fns]
            graph = torch.cuda.CUDAGraph()
            for g in entry.gens:
                graph.register_generator_state(g)
            t0 = time.perf_counter()
            graph.capture_begin()
            try:
                self._body(entry.state, entry.gens)
            except RuntimeError as err:
                failed = err
            finally:
                try:
                    graph.capture_end()
                except RuntimeError as err:
                    failed = failed or err
            entry.capture_ms = (time.perf_counter() - t0) * 1e3
        current.wait_stream(stream)
        # the capture launched nothing: take back what the wrappers counted
        for fn, b in zip(fns, before):
            if fn.launches != b:
                entry.per_iteration[fn] = fn.launches - b
                fn.launches = b
        if failed is not None:
            raise CaptureError(f"CUDA graph capture of the {self.name} failed at "
                               f"{_where(failed)}: {failed}") from failed
        entry.graph = graph
        _CACHE[self._key] = entry
        while len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)
