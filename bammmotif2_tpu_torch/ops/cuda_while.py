"""The EM loop's stop test on the card, and the CUDA graph WHILE node that
runs a captured iteration until the test fails: the binding of
``csrc/while_loop.cu``.

Port of the device side of the reference's ``jax.lax.while_loop``
(``bammmotif2_tpu/refinement/multi.py::batched_while_loop`` and its
``cond``).  ``condition`` writes ``running = max(its) < cap & max(vds) >=
eps`` (one block); on CPU tensors it runs the plain version
``condition_ref``, on CUDA tensors it launches the kernel or raises.
``WhileGraph`` wraps a captured iteration's graph in a WHILE node whose
body ends with the same kernel, which also sets the node's condition, so
one launch runs the loop to its end (``refinement/graphs.py::Loop.
run_while``).  WHILE nodes need a CUDA driver of 12.3 or later
(``MIN_DRIVER``).

Nothing here runs at import time: the library builds at first use.
"""

from __future__ import annotations

import ctypes

import torch

from bammmotif2_tpu_torch.ops import _build

MIN_DRIVER = 12030  # cudaDriverGetVersion of CUDA 12.3, the first with WHILE nodes
# cudaGraphNodeType values (driver_types.h), for node_types' report
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
              9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 13: "conditional"}


def library() -> ctypes.CDLL:
    lib = _build.load("while_loop")
    if lib.while_graph_build.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        pi = ctypes.POINTER(ctypes.c_int)
        lib.while_driver_version.argtypes = [pi]
        lib.while_runtime_version.argtypes = []
        lib.loop_condition_launch.argtypes = [p] * 5 + [i, p]
        lib.while_graph_node_types.argtypes = [p, pi, i, pi]
        lib.while_graph_build.argtypes = [p] * 7 + [i, ctypes.POINTER(p), ctypes.POINTER(p), pi]
        lib.while_graph_launch.argtypes = [p, p]
        lib.while_graph_destroy.argtypes = [p, p]
        lib.while_error_string.argtypes = [i]
        lib.while_error_string.restype = ctypes.c_char_p
        for fn in (lib.while_driver_version, lib.while_runtime_version,
                   lib.loop_condition_launch, lib.while_graph_node_types, lib.while_graph_build,
                   lib.while_graph_launch, lib.while_graph_destroy):
            fn.restype = i
    return lib


def _raise(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {library().while_error_string(err).decode()}")


def driver_version() -> int:
    """The CUDA driver's version as cudaDriverGetVersion gives it (12030 is
    12.3)."""
    out = ctypes.c_int(0)
    _raise("cudaDriverGetVersion", library().while_driver_version(ctypes.byref(out)))
    return out.value


def runtime_version() -> int:
    """CUDART_VERSION of the toolkit the library was built with."""
    return library().while_runtime_version()


def condition_ref(its: torch.Tensor, vds: torch.Tensor, cap: torch.Tensor,
                  eps: torch.Tensor) -> torch.Tensor:
    """The plain version: the group's loop condition (the reference's
    ``cond``), a 0-d bool tensor on the tensors' device.  A NaN in ``vds``
    makes its max NaN, which compares false."""
    return (its.max() < cap) & (vds.max() >= eps)


def _check(its, vds, cap, eps, running) -> None:
    dev = its.device
    for name, t, dtype, shape in (
        ("its", its, torch.int32, None), ("vds", vds, torch.float32, tuple(its.shape)),
        ("cap", cap, torch.int32, ()), ("eps", eps, torch.float32, ()),
        ("running", running, torch.bool, ()),
    ):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}; all inputs must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if its.dim() != 1 or its.shape[0] < 1:
        raise ValueError(f"want its [M] with M >= 1, got {tuple(its.shape)}")


def condition(its: torch.Tensor, vds: torch.Tensor, cap: torch.Tensor, eps: torch.Tensor,
              running: torch.Tensor) -> None:
    """Write the loop condition into ``running`` (a 0-d bool tensor) on the
    current stream: its [M] int32, vds [M] f32, cap [] int32, eps [] f32.
    ``condition.launches`` counts kernel launches: one a call, and one an
    iteration of a loop graph (``refinement/graphs.py::settle``)."""
    if all(t.device.type == "cpu" for t in (its, vds, cap, eps, running)):
        running.copy_(condition_ref(its, vds, cap, eps))
        return
    _check(its, vds, cap, eps, running)
    lib = library()
    dev = its.device
    with torch.cuda.device(dev):
        err = lib.loop_condition_launch(its.data_ptr(), vds.data_ptr(), cap.data_ptr(),
                                        eps.data_ptr(), running.data_ptr(), its.shape[0],
                                        torch.cuda.current_stream(dev).cuda_stream)
    _raise("loop_condition launch", err)
    condition.launches += 1


condition.launches = 0


def node_types(graph: int) -> dict:
    """Node type -> count of the cudaGraph_t ``graph`` (a captured body)."""
    lib = library()
    n = ctypes.c_int(0)
    _raise("cudaGraphGetNodes", lib.while_graph_node_types(graph, None, 0, ctypes.byref(n)))
    types = (ctypes.c_int * max(n.value, 1))()
    _raise("cudaGraphNodeGetType", lib.while_graph_node_types(graph, types, n.value,
                                                              ctypes.byref(n)))
    out: dict = {}
    for t in types[: n.value]:
        name = NODE_TYPES.get(t, str(t))
        out[name] = out.get(name, 0) + 1
    return out


_STAGES = {1: "cudaGraphCreate", 2: "cudaGraphConditionalHandleCreate", 3: "the start node",
           4: "the WHILE node", 5: "the body's child-graph node", 6: "the condition node",
           7: "cudaGraphInstantiate"}


class WhileGraph:
    """An instantiated loop graph: ``body`` (a captured iteration's
    cudaGraph_t, copied in as a child graph) runs while the condition of
    the state's (its, vds, cap, eps) holds, tested from ``running`` before
    the first iteration and by the condition kernel after each, which adds
    one to ``count`` (int64 []) an iteration.  Their addresses are baked
    into the graph, which keeps the tensors alive."""

    def __init__(self, body: int, its, vds, cap, eps, running, count):
        _check(its, vds, cap, eps, running)
        if count.dtype != torch.int64 or count.shape != () or count.device != its.device:
            raise ValueError("count must be an int64 [] tensor on the loop's device")
        version = driver_version()
        if version < MIN_DRIVER:
            raise RuntimeError(f"the CUDA driver is {version // 1000}.{version % 1000 // 10}; "
                               f"a WHILE graph node needs 12.3 or later")
        lib = library()
        self._lib = lib
        self._exec, self._graph = ctypes.c_void_p(), ctypes.c_void_p()
        stage = ctypes.c_int(0)
        with torch.cuda.device(its.device):
            err = lib.while_graph_build(body, its.data_ptr(), vds.data_ptr(), cap.data_ptr(),
                                        eps.data_ptr(), running.data_ptr(), count.data_ptr(),
                                        its.shape[0], ctypes.byref(self._exec),
                                        ctypes.byref(self._graph), ctypes.byref(stage))
        _raise(f"building the loop graph at {_STAGES.get(stage.value, stage.value)}", err)
        self.device = its.device
        self._tensors = (its, vds, cap, eps, running, count)
        self.launches = 0

    def launch(self) -> None:
        """One run of the loop on the current stream."""
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _raise("launching the loop graph", self._lib.while_graph_launch(self._exec, stream))
        self.launches += 1

    def __del__(self) -> None:
        lib, self._lib = getattr(self, "_lib", None), None
        if lib is not None:
            lib.while_graph_destroy(self._exec, self._graph)
