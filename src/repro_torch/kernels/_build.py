"""Build, load and launch the CUDA codec kernels (``csrc/codec.cu``).

``nvcc`` compiles the sources into one shared library with a plain C
interface, for ``sm_90a`` (Hopper), at first use.  The library lands in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.  It is
loaded with ``ctypes``: pointers and the stream pass as ``c_void_p``, sizes as
``c_int``/``c_longlong``.

A missing ``nvcc`` or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "codec.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA codec kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcodec_{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the hashed library already exists.

    The compiler writes to a temporary name and the result is renamed into
    place, so concurrent builders never load a half-written library.  With
    ``verbose`` the compiler's register/shared-memory report is printed."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded codec library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.codec_xor_reduce.argtypes = [vp, vp, ll, i, ll, i, vp]
            lib.codec_xor_reduce.restype = i
            lib.codec_gf256_matmul.argtypes = [vp, vp, vp, i, i, ll, ll, i, vp]
            lib.codec_gf256_matmul.restype = i
            _lib = lib
        return _lib


def check_operand(x: torch.Tensor, ndim: int, name: str) -> str:
    """Validate a kernel operand; return the path its device picks.

    ``"cpu"`` means the plain version runs; ``"cuda"`` means the kernel is
    launched.  Any other device, dtype, rank or a non-contiguous CUDA tensor
    raises."""
    if x.dtype != torch.int32 or x.ndim != ndim:
        raise TypeError(f"{name}: want a {ndim}-d int32 tensor, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: CUDA operands must be contiguous")
    return "cuda"


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch(fn_name: str, *args) -> None:
    """Call a C entry point on the current stream; raise if it failed."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(load(), fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
