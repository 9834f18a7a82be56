"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — seconds per
source, where a build against PyTorch's headers takes minutes. The build
happens at first use, into ``build/torch_kernels/`` beside the package,
with every source's ``nvcc`` started at once. A library is named by the
hash of its source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds and an unchanged one is loaded as
it is.

``nvcc`` is found through ``CUDA_HOME`` (as PyTorch resolves it: the
``CUDA_HOME``/``CUDA_PATH`` variables, then ``PATH``, then the toolkit's
usual root). If there is none, or a build fails, this raises: there is no
quiet fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later
#: kernels; ``-Xptxas -v`` reports registers, shared memory and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_VOID = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
_F32 = ctypes.c_float

#: Each kernel's C entry point: (source stem under ``csrc/``, function
#: name, argtypes). One source may hold several entry points. Pointers and
#: the stream are ``c_void_p`` so ctypes never truncates them.
#: Every kernel takes its launch parameters after ``scale``. The flash
#: kernels: warps per block, splits (the forward's and dQ's key splits,
#: dK/dV's query splits) and the padded head dim; the ragged kernel:
#: splits per (row, head) and stages.
_FLASH_TAIL = [_INT] * 6 + [_F32] + [_INT] * 3
_FLOAT32_ENTRY_POINTS = {
    "flash_attention_fwd": (
        "flash_attention_fwd", [_VOID] * 6 + _FLASH_TAIL + [_I64] * 9 + [_VOID],
    ),
    "flash_attention_bwd_dq": (
        "flash_attention_bwd", [_VOID] * 8 + _FLASH_TAIL + [_I64] * 12 + [_VOID],
    ),
    "flash_attention_bwd_dkv": (
        "flash_attention_bwd", [_VOID] * 9 + _FLASH_TAIL + [_I64] * 12 + [_VOID],
    ),
    "ragged_paged_attention": (
        "ragged_paged_attention",
        [_VOID, _I64, _VOID, _VOID, _VOID, _VOID, _INT, _VOID, _INT, _VOID,
         _VOID, _VOID, _I64, _VOID, _INT, _INT, _INT, _INT, _F32,
         _INT, _INT, _VOID],
    ),
}
#: The bf16 instantiations sit in the same sources under ``<name>_bf16``
#: and take the same arguments (their tensors bf16, lse/delta/scales fp32).
ENTRY_POINTS = {
    f"{name}{suffix}": (stem, f"{name}{suffix}", argtypes)
    for suffix in ("", "_bf16")
    for name, (stem, argtypes) in _FLOAT32_ENTRY_POINTS.items()
}


@dataclass(frozen=True)
class BuiltKernel:
    """One kernel's C entry point plus what its source's build said."""

    name: str
    source: str  # the stem under csrc/
    fn: object  # the ctypes function
    library: str
    seconds: float  # 0.0 when an earlier build was reused
    compiler_output: str


def find_nvcc() -> str:
    """Path of ``nvcc``; raises ``RuntimeError`` when the toolkit is
    missing."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from csrc/ at first use"
    )


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class KernelLibrary:
    """Builds every source once per process and hands out the loaded
    entry points. Thread-safe: the first caller builds, others wait."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: dict[str, BuiltKernel] | None = None

    def kernels(self) -> dict[str, BuiltKernel]:
        with self._lock:
            if self._kernels is None:
                self._kernels = self._build_all()
            return self._kernels

    def get(self, name: str):
        return self.kernels()[name].fn

    def _build_all(self) -> dict[str, BuiltKernel]:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        done = {}  # source stem -> (library, seconds, compiler output)
        for name in sorted({stem for stem, _, _ in ENTRY_POINTS.values()}):
            src = CSRC_DIR / f"{name}.cu"
            lib = BUILD_DIR / f"{name}-{_digest(src)}.so"
            if lib.exists():
                log = lib.with_suffix(".log")
                text = log.read_text() if log.exists() else ""
                done[name] = (lib, 0.0, text)
                continue
            tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            pending[name] = (proc, lib, tmp, time.perf_counter())
        failures = []
        for name, (proc, lib, tmp, t0) in pending.items():
            # Every nvcc is waited for, so none outlives a failed build.
            text, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(
                    f"nvcc failed for csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{text}"
                )
                continue
            lib.with_suffix(".log").write_text(text)
            os.replace(tmp, lib)  # atomic: readers never see half a file
            done[name] = (lib, seconds, text)
        if failures:
            raise RuntimeError("\n".join(failures))
        libs = {stem: ctypes.CDLL(str(lib)) for stem, (lib, _, _) in done.items()}
        out = {}
        for name, (stem, fn_name, argtypes) in ENTRY_POINTS.items():
            lib, seconds, text = done[stem]
            fn = getattr(libs[stem], fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            out[name] = BuiltKernel(name, stem, fn, str(lib), seconds, text)
        return out


#: The process's kernel set, built on first use.
LIBRARY = KernelLibrary()
