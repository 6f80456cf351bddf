"""The EM iteration's model update and loop-state step on the card: the
binding of ``csrc/em_update.cu``.

``em_update`` runs, in one launch for M seeds, what follows B1's data pass
(``cuda_em.em_pass``) inside the EM loop's body: the rounding of the
pass's float64 counts and the ll sum, the interpolated estimator of every
order, q's update, the L1 change, the loop state's per-seed updates and
the next iteration's log-odds LUT (``refinement/multi.py::FusedStep``).
Its plain version is the PyTorch chain it replaces (``multi.update`` and
``multi.advance`` after a data pass), which the CPU, ``--no-pallas`` and a
mesh run and the card tests hold it to.

Nothing here runs at import time: the library builds at first use.
"""

from __future__ import annotations

import ctypes

import torch

from bammmotif2_tpu_torch.ops import _build, encode

# Bytes of a seed's count table [R+1, W] that the kernel keeps in shared
# memory (em_update.cu's kSmemTable); larger tables go through device memory.
SMEM_TABLE = 48 * 1024 - 256 * 8


def table_in_smem(R1: int, W: int) -> bool:
    """Whether ``em_update`` keeps a seed's count table [R1, W] in shared
    memory (else in a device-memory ``work`` buffer): A=4 up to K=3 at
    W=30 and K=4 at W=8."""
    return 4 * R1 * W <= SMEM_TABLE


def library() -> ctypes.CDLL:
    lib = _build.load("em_update")
    if lib.em_update_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.em_update_launch.argtypes = [p] * 16 + [i] * 6 + [ctypes.c_float] + [i] * 3 + [p]
        lib.em_update_launch.restype = i
        lib.em_update_error_string.argtypes = [i]
        lib.em_update_error_string.restype = ctypes.c_char_p
    return lib


def _check(tensors: dict, shapes: dict) -> None:
    dev = tensors["Cd"].device
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} on {t.device}; all inputs must share one CUDA device")
        dtype = {"Cd": torch.float64, "its": torch.int32, "running": torch.bool}.get(
            name, torch.float32)
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, want {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shapes[name]}")


def em_update(Cd, logz, v, s_flat, q, lls, vds, its, hist, running, eps, alphas, f_bg, bg_flat,
              *, n_real: float, optimize_q: bool, hist_slots: int = 0, hist_stride: int = 1,
              C=None) -> None:
    """One EM iteration after B1's pass, for M seeds, on the current stream.

    Cd f64 [M, R+1, W] (set to zero), logz f32 [M, N]; the loop state v f32
    [M, R, W] (the orders stacked, ``motif.combined_v``), s_flat f32 [M,
    R+1, W], q, lls, vds f32 [M], its int32 [M], hist f32 [max(hist_slots,
    1), M], updated in place for the active seeds (``running`` bool [] and
    vds >= eps f32 []); alphas f32 [M, K+1, W], f_bg f32 [A], bg_flat f32
    [R].  ``n_real``: the rows that count (the others have length 0 and
    each adds log(1 - q) to ll).  ``C`` f32 [M, R+1, W], where given, gets
    the rounded counts.  ``em_update.launches`` counts launches.
    """
    M, R1, W = Cd.shape
    K = alphas.shape[1] - 1
    A = f_bg.shape[0]
    R = encode.num_rows(A, K)
    N = logz.shape[1]
    tensors = dict(Cd=Cd, logz=logz, v=v, s_flat=s_flat, q=q, lls=lls, vds=vds, its=its,
                   hist=hist, running=running, eps=eps, alphas=alphas, f_bg=f_bg,
                   bg_flat=bg_flat, **({} if C is None else {"C": C}))
    _check(tensors, dict(Cd=(M, R + 1, W), logz=(M, N), v=(M, R, W), s_flat=(M, R + 1, W),
                         q=(M,), lls=(M,), vds=(M,), its=(M,), hist=(max(hist_slots, 1), M),
                         running=(), eps=(), alphas=(M, K + 1, W), f_bg=(A,), bg_flat=(R,),
                         C=(M, R + 1, W)))
    dev = Cd.device
    work = None if table_in_smem(R + 1, W) else torch.empty((M, R + 1, W), device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = library().em_update_launch(
            Cd.data_ptr(), logz.data_ptr(), ptr(C), v.data_ptr(), s_flat.data_ptr(),
            q.data_ptr(), lls.data_ptr(), vds.data_ptr(), its.data_ptr(), hist.data_ptr(),
            running.data_ptr(), eps.data_ptr(), alphas.data_ptr(), f_bg.data_ptr(),
            bg_flat.data_ptr(), ptr(work), M, A, K, W, N, N - int(n_real), float(n_real),
            int(optimize_q), hist_slots, hist_stride, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"em_update launch failed: {library().em_update_error_string(err).decode()}")
    em_update.launches += 1


em_update.launches = 0
