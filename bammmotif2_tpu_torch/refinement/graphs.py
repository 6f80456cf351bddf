"""Device-resident loops: one iteration captured as a CUDA graph and replayed.

The reference runs EM's convergence loop in ``lax.while_loop`` and the CGS
sweeps in ``lax.scan``: one device program that the host starts and reads
(``bammmotif2_tpu/refinement/multi.py::batched_while_loop``,
``gibbs.py::gibbs_optimize`` and its ``lru_cache``d ``_batched_gibbs_loop``).
Here a loop's iteration is a ``body(state)`` that reads its inputs and
updates its state in place (``copy_`` into the state's buffers).  ``Loop``
runs it:

  * on a CUDA device, when ``enabled``: the state and inputs live in static
    buffers.  The first iteration runs eagerly, as a real iteration, on a
    capture stream of the device (it warms the kernel launchers' cached
    queries and creates ``ops.cuda_counts.workspace``'s buffers for that
    stream); then the body is captured once as a ``torch.cuda.CUDAGraph``,
    and each further iteration is one replay.  Captured loops stay in a
    small cache keyed by the loop's name, its constants and its tensors'
    shapes, the counterpart of the
    reference's ``lru_cache``: a later call with the same key (the next
    group of equal shape, the next FDR fold) copies its inputs and initial
    state into the static buffers and replays at once;
  * elsewhere (the CPU, a gloo mesh, ``graphs=False``): the same body runs
    eagerly on the caller's tensors, so the CPU tests cover the code that
    the graph captures.

A loop whose state holds the reference's stop test (``until``: EM's
convergence loop; CGS's sweeps, whose test is the sweep count) runs on the
device to its end, as ``lax.while_loop`` and ``lax.scan`` do, where
``device_loop`` allows it: the iteration is captured as above,
without the test, and wrapped in a CUDA graph WHILE node
(``ops.cuda_while.WhileGraph``) whose body ends with the test's kernel,
which sets the node's condition.  One launch runs every iteration, and the
host reads nothing until the caller reads the results.  Elsewhere (the
eager loop, a mesh) the test runs after each iteration as the body's last
step, and the caller reads the flag between chunks of iterations
(``run``).

A body need not be a loop's: the FDR group program
(``evaluation/fdr.py::_tail``) runs its fold tail as one step a fold, the
fold's index and model copied into the state between steps, its outputs
(``outputs``) made once per capture.

The rule (``enabled``): graphs iff the device is CUDA and there is no mesh
or the mesh's data group runs NCCL, whose in-place all-reduce joins the
graph.  A gloo group stages CUDA tensors through host memory
(``parallel.mesh.all_reduce``) and cannot be captured.  The rule is chosen
before any capture; a capture that fails raises ``CaptureError`` naming the
loop and the operation, and nothing runs the eager loop instead.  So does a
loop graph that cannot be built (``device_loop`` chose it): nothing goes
back to the chunked loop.

Under an active trace (``utils.metrics``) each capture is a
``graph.capture`` span and counts ``graph.capture``; a call that finds
its key cached counts ``graph.hit``, and each loop the cache drops
``graph.evict``.  Where ``settle`` reads a device loop's iterations it
counts the device operations they ran inside the loop graph's WHILE node
(``graph.loop_ops``: an iteration's kernel, memcpy and memset nodes and
its stop test's kernel).  A profiler that traces CUDA keeps a record of
each operation run inside a WHILE node, and CUPTI 12.8 (CUDA 13.0, H100)
holds about 349,500 such records a process and recycles none: past them
the traced process drops records or faults with an illegal memory access
(PERF.md).  So ``graph.loop_ops`` is what a traced run spends of that
store.

Launch counters (``ops.cuda_*``'s ``.launches``) count launches: the
wrappers add one when the body is captured, which launches nothing, so the
capture's additions are taken back and added once per replay.  A device
loop's iteration count stays on the device: ``settle`` adds its launches
where the caller reads the loop's results.
"""

from __future__ import annotations

import collections
import os
import traceback

import torch

from bammmotif2_tpu_torch.utils import metrics

CACHE_SIZE = 8  # captured loops kept (each holds its static buffers and graph pool)

# key -> _Captured, least recently used first
_CACHE: collections.OrderedDict = collections.OrderedDict()
_STREAMS: dict = {}  # device index -> the capture stream
# id -> _Captured: device loops launched since the last ``settle``
_UNSETTLED: dict = {}


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


def device_loop(device, mesh=None) -> bool:
    """Whether a loop that holds its stop test (``Loop``'s ``until``) runs
    to its end on the device as one WHILE-node graph: it is graphed
    (``enabled``) and has no mesh.  A body looped on the device draws from
    keys read on the device (``ops.cuda_draws``), never from a
    ``torch.Generator``, whose offsets a replay advances from the host."""
    return mesh is None and enabled(device)


def counted() -> tuple:
    """The kernel wrappers whose ``.launches`` count launches."""
    from bammmotif2_tpu_torch.ops import (
        cuda_counts, cuda_draws, cuda_em, cuda_flat, cuda_scores, cuda_update, cuda_while,
    )

    return (cuda_em.em_counts_multi, cuda_update.em_update, cuda_scores.window_scores_multi,
            cuda_counts.counts_from_r_multi, cuda_flat.em_counts, cuda_flat.window_scores,
            cuda_flat.counts_from_r, cuda_while.condition, cuda_draws.markov_codes,
            cuda_draws.cgs_z, cuda_draws.cgs_beta)


def settle() -> None:
    """Add the iterations that device loops ran since the last call to the
    launch counters (each wrapper's launches an iteration, and the stop
    test's kernel once), to their loops' replays and to the active trace's
    ``graph.loop_ops``: one host read a loop.
    Call it where the loops' results are read."""
    if not _UNSETTLED:
        return
    from bammmotif2_tpu_torch.ops import cuda_while

    for entry in _UNSETTLED.values():
        total = int(entry.count.item())
        n, entry.settled = total - entry.settled, total
        entry.replays += n
        for fn, d in entry.per_iteration.items():
            fn.launches += d * n
        cuda_while.condition.launches += n
        metrics.count("graph.loop_ops", n * body_ops(entry.body_nodes))
    _UNSETTLED.clear()


def body_ops(body_nodes: dict) -> int:
    """The device operations one iteration of a loop graph runs, from its
    captured body's node types (``ops.cuda_while.node_types``): the kernel,
    memcpy and memset nodes, and the stop test's kernel.  The port's
    captured bodies hold no other node that runs device work (no child
    graph, no conditional node): the card tests check it on every loop."""
    return sum(body_nodes.get(t, 0) for t in ("kernel", "memcpy", "memset")) + 1


def clear() -> None:
    """Drop every captured loop."""
    _CACHE.clear()


def stats() -> list:
    """One dict a cached loop: its name, capture ms (its ``graph.capture``
    span: the warm-up iteration, the capture and a device loop's loop
    graph), calls (the capture's and later hits) and replays (a device
    loop's settled iterations); a device loop's also its loop graph's
    launches and its captured body's node types."""
    out = []
    for c in _CACHE.values():
        d = {"name": c.name, "capture_ms": c.capture_ms, "calls": c.calls, "replays": c.replays}
        if c.while_graph is not None:
            d.update(while_launches=c.while_graph.launches, body_nodes=c.body_nodes)
        out.append(d)
    return out


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
    """A cached loop: static state and inputs and the graph of one
    iteration, with the launches one iteration makes."""

    def __init__(self, name, state, inputs, mesh):
        self.name, self.state, self.inputs = name, state, inputs
        self.mesh = mesh  # pinned: the key holds its id
        self.graph = None  # a device loop's keeps the body's memory pool
        self.while_graph = None  # a device loop's ops.cuda_while.WhileGraph
        self.body_nodes: dict = {}
        # a device loop's iterations, summed over its launches on the device,
        # and the part of them that ``settle`` has counted
        self.count = None
        self.settled = 0
        self.per_iteration: dict = {}
        self.capture_ms = 0.0
        self.calls = 1
        self.replays = 0


class Loop:
    """One run of a loop's iteration ``body(state)``.

    ``state``: name -> tensor or tuple of tensors, the loop's state: fresh
    tensors that the loop owns and updates.  ``inputs``: name -> tensor,
    what the body reads and never writes; the body reads them through this
    dict, whose values the loop replaces by its static copies.  ``key``:
    hashable, the body's constants; with the loop's name, the device, the
    mesh and the tensors' shapes and dtypes it decides which captured graph
    a call reuses.

    ``outputs``: name -> a function of no arguments making a state tensor
    that the body writes whole before it reads it (a fold's scores, where
    the body is not a loop but a step run once per fold): it is made where
    no captured loop of the key has it, and never copied in, so its shape
    must follow from ``key`` and the other tensors' shapes.

    ``until``: the names of the state's (running, its, vds, cap, eps):
    the loop holds the reference's stop test, ``running = max(its) < cap &
    max(vds) >= eps``, which runs after each iteration of the body.  Where
    ``device_loop`` allows (``on_device``), ``run_while`` runs the loop to
    its end on the device; elsewhere ``run(n)`` runs n iterations and the
    caller reads ``running`` between chunks (CGS, whose count is fixed,
    runs them in one).

    After construction read the state from ``.state`` (the static buffers
    when graphed: copy out what must outlive the next loop of the same key)
    and call ``run(n)`` for n iterations, or ``run_while()``.
    """

    def __init__(self, name: str, key, state: dict, inputs: dict, body, *,
                 outputs=None, mesh=None, graphs: bool = True, until=None):
        self.name, self._body, self._until = name, body, until
        self.device = next(_tensors(state)).device
        self._entry = None
        self.on_device = False
        outputs = outputs or {}
        if not (graphs and enabled(self.device, mesh)):
            self.state = _with_outputs(state, outputs)
            return
        self.on_device = until is not None and device_loop(self.device, mesh)
        self._key = (name, key, str(self.device), _signature(state), _signature(inputs),
                     tuple(sorted(outputs)), None if mesh is None else id(mesh), self.on_device)
        entry = _CACHE.get(self._key)
        if entry is None:
            entry = _Captured(name, _with_outputs(state, outputs),
                              {k: t.clone() for k, t in inputs.items()}, mesh)
            if self.on_device:
                entry.count = torch.zeros((), dtype=torch.int64, device=self.device)
        else:
            _CACHE.move_to_end(self._key)
            entry.calls += 1
            metrics.count("graph.hit")
            for k, t in state.items():  # the outputs are not in it
                _copy_into(entry.state[k], t)
            for k, t in inputs.items():
                entry.inputs[k].copy_(t)
        inputs.update(entry.inputs)
        self._entry, self.state = entry, entry.state

    @property
    def graphed(self) -> bool:
        return self._entry is not None

    def _test(self, state: dict) -> tuple:
        """The stop test's tensors in ``state``: (running, its, vds, cap, eps)."""
        return tuple(state[k] for k in self._until)

    def _step(self, state: dict) -> None:
        """One iteration and, with ``until``, the stop test's plain version."""
        self._body(state)
        if self._until is not None:
            from bammmotif2_tpu_torch.ops.cuda_while import condition_ref

            running, *args = self._test(state)
            running.copy_(condition_ref(*args))

    def run(self, n: int) -> None:
        """n iterations: eager, or graphed (a new key's first iteration runs
        eagerly and is then captured; the rest replay)."""
        if self.on_device:
            raise RuntimeError(f"the {self.name} runs on the device: call run_while")
        if n <= 0:
            return
        entry = self._entry
        if entry is None:
            for _ in range(n):
                self._step(self.state)
            return
        if entry.graph is None:
            self._warm_up_and_capture(entry)
            n -= 1
        for _ in range(n):
            entry.graph.replay()
        entry.replays += n
        for fn, d in entry.per_iteration.items():
            fn.launches += d * n

    def run_while(self) -> None:
        """The loop to its end in one launch of its loop graph (``on_device``):
        a new key's first iteration runs eagerly, with the stop test's
        kernel, and is then captured and wrapped; the loop graph runs the
        rest.  Reads nothing on the host; ``settle`` counts the launches."""
        if not self.on_device:
            raise RuntimeError(f"the {self.name} does not run on the device: call run(n)")
        entry = self._entry
        if entry.while_graph is None:
            self._warm_up_and_capture(entry)
        entry.while_graph.launch()
        _UNSETTLED[id(entry)] = entry

    def _warm_up_and_capture(self, entry: _Captured) -> None:
        """The warm-up iteration, the capture and (a device loop) the loop
        graph, inside a ``graph.capture`` span: its seconds are the entry's
        ``capture_ms``."""
        with metrics.span("graph.capture", loop=self.name) as sp:
            self._capture(entry)
        entry.capture_ms = sp.seconds * 1e3
        metrics.count("graph.capture")

    def _capture(self, entry: _Captured) -> None:
        stream = _STREAMS.get(self.device.index)
        if stream is None:
            stream = _STREAMS[self.device.index] = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        fns = counted()
        failed = None
        # a device loop's captured body leaves the test to the loop graph
        captured = self._body if self.on_device else self._step
        with torch.cuda.stream(stream):
            captured(entry.state)  # a real iteration, counted
            if self.on_device:
                from bammmotif2_tpu_torch.ops import cuda_while

                running, *args = self._test(entry.state)
                cuda_while.condition(*args, running)
            before = [fn.launches for fn in fns]
            graph = torch.cuda.CUDAGraph(keep_graph=self.on_device)
            graph.capture_begin()
            try:
                captured(entry.state)
            except RuntimeError as err:
                failed = err
            finally:
                try:
                    graph.capture_end()
                except RuntimeError as err:
                    failed = failed or err
        current.wait_stream(stream)
        # the capture launched nothing: take back what the wrappers counted
        for fn, b in zip(fns, before):
            if fn.launches != b:
                entry.per_iteration[fn] = fn.launches - b
                fn.launches = b
        if failed is not None:
            raise CaptureError(f"CUDA graph capture of the {self.name} failed at "
                               f"{_where(failed)}: {failed}") from failed
        if self.on_device:
            self._wrap(entry, graph)
        entry.graph = graph
        _CACHE[self._key] = entry
        while len(_CACHE) > CACHE_SIZE:
            _CACHE.popitem(last=False)
            metrics.count("graph.evict")

    def _wrap(self, entry: _Captured, graph) -> None:
        """Build ``entry``'s loop graph around the captured body ``graph``."""
        from bammmotif2_tpu_torch.ops import cuda_while

        try:
            body = int(graph.raw_cuda_graph())
            entry.body_nodes = cuda_while.node_types(body)
            running, *args = self._test(entry.state)
            entry.while_graph = cuda_while.WhileGraph(body, *args, running, entry.count)
        except (RuntimeError, OSError, TypeError) as err:
            raise CaptureError(f"the loop graph of the {self.name} could not be built "
                               f"(body nodes {entry.body_nodes}): {err}") from err
