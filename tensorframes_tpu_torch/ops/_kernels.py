"""Build and load the port's CUDA kernel.

``ops/csrc/ragged_paged_attention.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
build happens at first use, never at import, into ``ops/_build/``
(git-ignored), named by a digest of the source and flags so an edited
source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["build", "library", "launch_ragged_paged_attention"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "ragged_paged_attention.cu"
_BUILD_DIR = _HERE / "_build"

_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernel "
            "builds from source at first use"
        )
    return path


def _target() -> Path:
    digest = hashlib.sha1(
        _SRC.read_bytes() + " ".join(_FLAGS).encode()
    ).hexdigest()[:12]
    return _BUILD_DIR / f"libtft_ragged_paged_attention_{digest}.so"


def build() -> dict:
    """Compile the kernel library unless it is built already. Raises with
    the compiler's output when the build fails. Returns ``{"seconds":
    build wall time (0.0 when cached), "ptxas": compiler log}``."""
    so = _target()
    if so.exists():
        return {"seconds": 0.0, "ptxas": ""}
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *_FLAGS, "-o", str(tmp), str(_SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError("kernel build failed\n" + proc.stdout)
    os.replace(tmp, so)
    return {"seconds": time.perf_counter() - t0, "ptxas": proc.stdout}


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(_target()))
            P, I = ctypes.c_void_p, ctypes.c_int
            f = lib.tft_ragged_paged_attention
            f.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, P]
            f.restype = I
            g = lib.tft_ragged_paged_attention_smem_bytes
            g.argtypes = [I, I, I]
            g.restype = ctypes.c_size_t
            _lib = lib
    return _lib


#: dynamic shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def launch_ragged_paged_attention(
    q, k_pages, v_pages, page_table, lengths, out, qk_scale_log2: float
) -> None:
    """Launch the ragged paged-attention kernel on the current stream.
    The caller (``ops.attention.ragged_paged_attention``) has checked
    shapes, dtypes, devices and contiguity."""
    import torch

    lib = library()
    slots, n_kv, group, hd = q.shape
    ps = k_pages.shape[1]
    smem = lib.tft_ragged_paged_attention_smem_bytes(group, hd, ps)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"ragged_paged_attention needs {smem} bytes of shared memory per "
            f"block for group={group}, head_dim={hd}, page_size={ps}; the "
            f"card offers {_MAX_SMEM}"
        )
    dtype_code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.tft_ragged_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            slots, n_kv, group, hd, ps, page_table.shape[1], dtype_code,
            float(qk_scale_log2), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ragged_paged_attention launch failed: CUDA error {rc}"
        )
