"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by nvcc into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ctypes. Libraries go to ``build/kernels/`` at the root of
the checkout, named by a hash of their sources, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when
the package is imported: the first launch of a kernel builds it, and
``build_all()`` builds every kernel with one nvcc process each, all
started together; a source named in ``PARTS`` is compiled as that many
translation units at once (``-DREPRO_PART=i``) and linked into its one
library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("fmmu_translate", "fmmu_commit", "fmmu_lookup",
           "paged_attention", "flash_attention", "flash_attention_bwd",
           "mamba_scan", "mamba_scan_bwd", "fmmu_fsm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources compiled in parts: paged_attention.cu's 75 instantiations took
# ~110 s of ptxas in one process, the longest of the build
PARTS = {"paged_attention": 3}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _popen(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start(name: str):
    """Start nvcc for one kernel (one process a part); None when its
    library is current."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = str(CSRC / f"{name}.cu")
    if name not in PARTS:
        return [_popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), src])], [], \
            tmp, out
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_suffix(f".{i}.o") for i in range(PARTS[name])]
    procs = [_popen([_nvcc(), *flags, "-c", f"-DREPRO_PART={i}", "-o",
                     str(obj), src]) for i, obj in enumerate(objs)]
    return procs, objs, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    procs, objs, tmp, out = job
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for proc, log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if objs:
            link = _popen([_nvcc(), "-shared", "-o", str(tmp),
                           *map(str, objs)])
            log = link.communicate()[0]
            if link.returncode != 0:
                raise RuntimeError(f"nvcc failed to link {name}:\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return "".join(logs)


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Build every named kernel in parallel; returns nvcc's output
    (register and shared-memory use, from -Xptxas -v) per kernel."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, jobs[n]) for n in names}


def load(name: str, argtypes) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed.
    ``argtypes`` types the C entry point ``<name>_launch``: every
    pointer and the stream as c_void_p, so none is cut to 32 bits."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a nonzero cudaGetLastError()."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on the tensor's device, as an int."""
    return torch.cuda.current_stream(t.device).cuda_stream


# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def require(t: torch.Tensor, name: str, *, device: torch.device,
            dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` — what a kernel reads through a raw pointer."""
    if (t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device} (contiguous={t.is_contiguous()})")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors, via: str = "") -> None:
    """Raise where a kernel wrapper without a backward would be recorded
    by autograd: its output, written through a raw pointer, would carry
    no gradient and the inputs' gradients would silently miss its share.
    ``via`` names the differentiable entry point where one exists."""
    if needs_grad(*tensors):
        what = (f"this wrapper is not differentiable; call {via}" if via
                else "the CUDA kernel has no backward")
        raise NotImplementedError(
            f"{name}: {what}, or call it under torch.no_grad() or with "
            "inputs that do not require grad (kernel_impl='ref' "
            "differentiates the plain version)")
