"""ctypes bindings for the native C++ FASTA codec (io/fasta_codec.cpp).

The port's copy of ``bammmotif2_tpu.io.native`` (the parser only).  The
shared library is compiled on first use with the system g++ into the
package's git-ignored ``_build/`` directory, named by a hash of the source
and the flags, so it never meets the JAX package's library.  Every entry
point degrades to ``None`` so callers fall back to the pure-numpy path
(utils/fasta.py) when no compiler is available.  Set ``BAMM_NO_NATIVE=1``
to disable.

Parity contract: byte-identical codes/lens/headers vs the Python parser on
every input (asserted in tests/test_torch_utils.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fasta_codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _build() -> str | None:
    """Compile the codec into BUILD_DIR; returns the library's path or None."""
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    tag = f"py{sys.version_info[0]}{sys.version_info[1]}_{digest}"
    out = os.path.join(BUILD_DIR, f"libbamm_fasta_{tag}.so")
    if os.path.exists(out):
        return out
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic vs concurrent builders
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("BAMM_NO_NATIVE"):
            _lib_failed = True
            return None
        path = _build()
        if path is None:
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i8, i8p = ctypes.c_int8, ctypes.POINTER(ctypes.c_int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bamm_fasta_scan.argtypes = [u8p, i64, i64p, i64p]
        lib.bamm_fasta_scan.restype = ctypes.c_int
        lib.bamm_fasta_fill.argtypes = [
            u8p, i64, i8p, i8p, i64, i64, i32p, i64p, i64p, i8,
        ]
        lib.bamm_fasta_fill.restype = i64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def read_fasta_encoded(path: str, alphabet=None):
    """Parse + encode a FASTA file natively.

    Returns (codes int8 [N, L_max], lens int32 [N], headers list[str]) or
    None if the native library is unavailable (callers must fall back).
    """
    lib = _load()
    if lib is None:
        return None
    from bammmotif2_tpu_torch.utils.alphabet import Alphabet
    from bammmotif2_tpu_torch.utils.fasta import PAD

    alphabet = alphabet or Alphabet.standard()
    buf = np.fromfile(path, dtype=np.uint8)
    n = np.int64(buf.size)
    if buf.size == 0:
        return np.zeros((0, 0), np.int8), np.zeros(0, np.int32), []
    n_seqs = ctypes.c_int64(0)
    max_len = ctypes.c_int64(0)
    rc = lib.bamm_fasta_scan(
        _ptr(buf, ctypes.c_uint8), n, ctypes.byref(n_seqs), ctypes.byref(max_len)
    )
    if rc != 0:
        return None
    N, L = int(n_seqs.value), int(max_len.value)
    table = alphabet._encode_table()  # int8[256]
    codes = np.empty((max(N, 1), max(L, 1)), np.int8)
    lens = np.zeros(max(N, 1), np.int32)
    hdr_off = np.zeros(max(N, 1), np.int64)
    hdr_len = np.zeros(max(N, 1), np.int64)
    wrote = lib.bamm_fasta_fill(
        _ptr(buf, ctypes.c_uint8), n, _ptr(table, ctypes.c_int8),
        _ptr(codes, ctypes.c_int8), np.int64(N), np.int64(L),
        _ptr(lens, ctypes.c_int32), _ptr(hdr_off, ctypes.c_int64),
        _ptr(hdr_len, ctypes.c_int64), np.int8(PAD),
    )
    if wrote != N:
        return None  # geometry mismatch (file changed underneath) — fall back
    bview = buf.tobytes()
    headers = [
        "unnamed" if off < 0 else bview[off : off + ln].decode("utf-8", "replace")
        for off, ln in zip(hdr_off[:N].tolist(), hdr_len[:N].tolist())
    ]
    return codes[:N, :L], lens[:N], headers
