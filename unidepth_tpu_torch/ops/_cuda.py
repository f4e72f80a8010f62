"""Build and load the port's CUDA kernels (``unidepth_tpu_torch/csrc``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per
source, all started together, and link into one shared library with a plain
C interface, loaded with ``ctypes``. The build runs at the first CUDA call
in a process, writes
``build/unidepth_tpu_torch/<hash of the sources and flags>/`` at the root of
the checkout, and is reused while the sources are unchanged. A failed build
raises: there is no fallback to the plain PyTorch versions.

Every pointer and the stream cross the C boundary as ``c_void_p``, and every
entry point returns the CUDA error of its launch, which ``check`` raises on.
``plain_vjp`` is the backward every kernel's ``torch.autograd.Function``
shares: the JAX package's ``custom_vjp`` policy of recomputing the plain
formulation and taking its VJP.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "unidepth_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libunidepth_kernels.so"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: RuntimeError | None = None  # a failed build is not retried in this process
#: seconds the last build in this process took (None: loaded from the cache)
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA kernels "
        "of unidepth_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built; returns
    the library path. Raises RuntimeError with the compiler output on a
    failed build."""
    global build_seconds
    out = BUILD_ROOT / _build_key() / LIB_NAME
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = out.parent / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(str(obj))
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text}")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    (out.parent / "nvcc.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed building {out}:\n" + "\n".join(failed))
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    build_seconds = time.perf_counter() - t0
    return out


def ptxas_reports(kernel: str) -> list[list[str]]:
    """What ptxas said about each entry function whose mangled name holds
    ``kernel`` as its identifier (after the identifier's length, so not the
    source file's name in an anonymous namespace's) when this source hash
    was built, in build order: registers, spills, shared memory. Empty when
    the build's log holds no such entry."""
    log = BUILD_ROOT / _build_key() / "nvcc.log"
    lines = log.read_text().splitlines() if log.is_file() else []
    named = re.compile(rf"\d{re.escape(kernel)}")
    reports = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and named.search(line):
            out = [line]
            for nxt in lines[i + 1 :]:
                if "Compiling entry function" in nxt or not nxt.startswith(("ptxas", " ")):
                    break
                out.append(nxt)
            reports.append(out)
    return reports


def ptxas_report(kernel: str) -> list[str]:
    """The first of ``ptxas_reports(kernel)``, or an empty list."""
    reports = ptxas_reports(kernel)
    return reports[0] if reports else []


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.ud_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i] + [ll] * 8 + [f, i, p]
    lib.ud_attention_fwd.restype = i
    lib.ud_attention_packed_fwd.argtypes = lib.ud_attention_fwd.argtypes
    lib.ud_attention_packed_fwd.restype = i
    lib.ud_attention_hopper_fwd.argtypes = lib.ud_attention_fwd.argtypes
    lib.ud_attention_hopper_fwd.restype = i
    lib.ud_ln_dense_fwd.argtypes = [p, p, p, p, p, p, i, i, i, f, i, i, p]
    lib.ud_ln_dense_fwd.restype = i
    lib.ud_ln_row_stats.argtypes = [p, p, i, i, f, p]
    lib.ud_ln_row_stats.restype = i
    lib.ud_ln_dense_hopper_fwd.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.ud_ln_dense_hopper_fwd.restype = i
    lib.ud_ln_swiglu_hopper_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.ud_ln_swiglu_hopper_fwd.restype = i
    lib.ud_head_mlp_hopper_fwd.argtypes = [p] * 11 + [i] * 4 + [f, f, p]
    lib.ud_head_mlp_hopper_fwd.restype = i
    lib.ud_conv3x3_fwd.argtypes = [p, p, p, p] + [i] * 7 + [p]
    lib.ud_conv3x3_fwd.restype = i
    lib.ud_conv3x3_hopper_fwd.argtypes = [p, p, p, p] + [i] * 6 + [p]
    lib.ud_conv3x3_hopper_fwd.restype = i
    lib.ud_conv3x3_head_hopper_fwd.argtypes = [p] * 6 + [i] * 6 + [f, p]
    lib.ud_conv3x3_head_hopper_fwd.restype = i
    lib.ud_attention_ab_fwd.argtypes = [p, p, p, p] + [i] * 6 + [p]
    lib.ud_attention_ab_fwd.restype = i
    lib.ud_attention_bd_fwd.argtypes = [p, p, p, p] + [i] * 5 + [p]
    lib.ud_attention_bd_fwd.restype = i
    lib.ud_attention_ab_hopper_fwd.argtypes = [p, p, p, p] + [i] * 4 + [ll] * 8 + [i, p]
    lib.ud_attention_ab_hopper_fwd.restype = i
    lib.ud_attention_bd_hopper_fwd.argtypes = lib.ud_attention_ab_hopper_fwd.argtypes
    lib.ud_attention_bd_hopper_fwd.restype = i
    lib.ud_error_string.argtypes = [i]
    lib.ud_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, _build_error
    with _lock:
        if _build_error is not None:
            raise _build_error
        if _lib is None:
            try:
                path = build()
            except RuntimeError as e:
                _build_error = e
                raise
            _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().ud_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Validate the tensors a kernel wrapper hands to C: one CUDA device,
    a dtype the kernels take, 16-byte aligned base pointers."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on the same CUDA device, got {t.device}")
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype} (float32 or bfloat16)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: base pointer is not 16-byte aligned")


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is when wider: the plain versions compute
    in at least float32, and float64 stays float64 (``gradcheck``)."""
    return t if t.dtype == torch.float64 else t.float()


def plain_vjp(fn, saved, needs, g):
    """The VJP of ``fn(*saved)`` for the cotangent ``g``: ``fn`` (a kernel's
    plain version) recomputed from the saved inputs under autograd. Returns
    one gradient per saved tensor, None where ``needs`` is False."""
    inputs = [None if t is None else t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
    wanted = [t for t, need in zip(inputs, needs) if need]
    if not wanted:
        return (None,) * len(inputs)
    with torch.enable_grad():
        out = fn(*inputs)
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if need else None for need in needs)
