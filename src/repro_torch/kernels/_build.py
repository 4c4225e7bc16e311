"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source to an object, all of them at once, and links
the objects into one shared library with a plain C interface, for ``sm_90a``
(Hopper), at first use (the SSD and attention sources share
``csrc/ssd_common.cuh``).
The library lands in ``build/repro_torch/`` at the root of the checkout,
named by a hash of the sources, the header and the flags, so an edit
rebuilds and an unchanged tree reuses it.  It is loaded with ``ctypes``:
pointers and the stream pass as ``c_void_p``, sizes as
``c_int``/``c_longlong``.

A missing ``nvcc`` or a failed build raises; there is no fallback.  So does
a device that cannot map pinned host memory, which the single-stripe codec
path reads and writes in place (:func:`require_host_mapping`).
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
SOURCES = (CSRC / "codec.cu", CSRC / "ssd_scan.cu", CSRC / "ssd_scan_bwd.cu",
           CSRC / "attention.cu", CSRC / "mamba_glue.cu")
HEADERS = (CSRC / "ssd_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_host_mapping_checked = False


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then /usr/local/cuda."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkernels_{_digest()}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the hashed library already exists.

    One ``nvcc -c`` per source runs in parallel; one more links the objects.
    Everything is written under temporary names and the library is renamed
    into place, so concurrent builders never load a half-written library.
    With ``verbose`` the compiler's register/shared-memory report is
    printed."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                 "-c", "-o", str(obj), str(src)] for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        results = [(c, p, *p.communicate()) for c, p in zip(cmds, procs)]
        lib = Path(tmp) / out.name
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]
        for cmd, proc, _, err in results:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
            if verbose:
                print(err, end="")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(link)}\n{res.stderr}")
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.codec_xor_reduce.argtypes = [vp, vp, ll, i, ll, i, vp]
            lib.codec_xor_reduce.restype = i
            lib.codec_gf256_matmul.argtypes = [vp, vp, vp, i, i, ll, ll, i, vp]
            lib.codec_gf256_matmul.restype = i
            lib.codec_stripe_xor.argtypes = [vp, vp, i, ll, i, vp, i]
            lib.codec_stripe_xor.restype = i
            lib.codec_stripe_gf256.argtypes = [vp, i, i, vp, vp, ll, i, vp, i]
            lib.codec_stripe_gf256.restype = i
            lib.codec_host_device_pointer.argtypes = [vp, ctypes.POINTER(vp)]
            lib.codec_host_device_pointer.restype = i
            lib.codec_can_map_host_memory.argtypes = [ctypes.POINTER(i)]
            lib.codec_can_map_host_memory.restype = i
            lib.ssd_scan.argtypes = [i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                     i, i, i, i, i, i, vp, vp]
            lib.ssd_chunk_gram.argtypes = [i, vp, vp, vp, i, i, i, i, vp, vp]
            lib.ssd_chunk_gram.restype = i
            lib.ssd_scan.restype = i
            lib.ssd_scan_bwd.argtypes = [i, *[vp] * 21, *[i] * 10, vp, vp]
            lib.ssd_scan_bwd.restype = i
            lib.causal_attention.argtypes = [vp, vp, vp, vp, *[i] * 8, ctypes.c_float, vp, vp]
            lib.causal_attention.restype = i
            lib.mamba_conv.argtypes = [*[vp] * 7, *[i] * 5, vp, vp]
            lib.mamba_conv.restype = i
            lib.mamba_gate_norm.argtypes = [*[vp] * 6, *[i] * 4, ctypes.c_float, vp, vp]
            lib.mamba_gate_norm.restype = i
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


def can_map_host_memory() -> bool:
    """``cudaDevAttrCanMapHostMemory`` of the current device."""
    can = ctypes.c_int(0)
    err = load().codec_can_map_host_memory(ctypes.byref(can))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed with error {err}")
    return bool(can.value)


def require_host_mapping() -> None:
    """Raise unless the device can map pinned host memory; asks it once."""
    global _host_mapping_checked
    if not _host_mapping_checked:
        if not can_map_host_memory():
            raise RuntimeError("the CUDA device cannot map pinned host memory, which "
                               "the single-stripe codec kernels read and write in place")
        _host_mapping_checked = True


def check_host_operand(x: torch.Tensor, ndim: int, name: str) -> None:
    """Validate an operand of a host-operand entry: a contiguous ``ndim``-d
    int32 tensor in pinned host memory; raise otherwise."""
    if x.dtype != torch.int32 or x.ndim != ndim:
        raise TypeError(f"{name}: want a {ndim}-d int32 tensor, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if x.device.type != "cpu" or not x.is_pinned():
        raise ValueError(f"{name}: host operands must lie in pinned host memory")
    if not x.is_contiguous():
        raise ValueError(f"{name}: host operands must be contiguous")


def host_device_pointer(x: torch.Tensor) -> int:
    """The card's address of a pinned host tensor's first element, from
    ``cudaHostGetDevicePointer`` on its storage (never assumed to equal the
    host address)."""
    require_host_mapping()
    base = x.untyped_storage().data_ptr()
    dev = ctypes.c_void_p()
    err = load().codec_host_device_pointer(ctypes.c_void_p(base), ctypes.byref(dev))
    if err != 0 or not dev.value:
        raise RuntimeError(f"cudaHostGetDevicePointer failed with error {err}")
    return dev.value + (x.data_ptr() - base)
