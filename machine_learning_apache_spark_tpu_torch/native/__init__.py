"""native — C++ host-runtime components with ctypes bindings; the port of
``machine_learning_apache_spark_tpu/native/__init__.py``.

The package's own copies of the three sources: a libsvm parser
(``libsvm_parser.cpp``), a threaded batch row-gather (``batch_gather.cpp``)
and one-pass batch text encoding (``text_encode.cpp``: tokenize + vocab
lookup + pad). Host code only: nothing here touches the card.

Build model: at first use the sources are compiled with the host ``g++``
(``-O3 -shared -fPIC``, plain C ABI, no pybind11) into
``build/native/_mlspark_native-<hash>.so`` beside the package, where the
hash covers the sources and the flags, so an edited source rebuilds and
an unchanged one is loaded as it is; the library is written to a temporary
name and renamed into place. A failed build is remembered for the
process: ``available()`` turns False, ``gather_rows`` answers with numpy
indexing, and the other bindings raise ``ImportError``, which callers
that have a Python parser (``data.libsvm.read_libsvm``) catch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("libsvm_parser.cpp", "batch_gather.cpp", "text_encode.cpp")
BUILD_DIR = SOURCE_DIR.parent.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SOURCE_DIR / name).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"_mlspark_native-{h.hexdigest()[:16]}.so"


def _build(so_path: Path) -> None:
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), *(str(SOURCE_DIR / s) for s in SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, so_path)  # atomic: a racing process loads a whole file
    except (subprocess.SubprocessError, OSError) as e:
        # compile errors, timeouts and a missing g++ alike
        detail = getattr(e, "stderr", "") or str(e)
        raise ImportError(f"native build failed: {detail}") from e
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mlspark_libsvm_parse.restype = ctypes.c_void_p
    lib.mlspark_libsvm_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.mlspark_libsvm_copy.restype = None
    lib.mlspark_libsvm_copy.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    lib.mlspark_libsvm_free.restype = None
    lib.mlspark_libsvm_free.argtypes = [ctypes.c_void_p]
    lib.mlspark_gather_rows.restype = None
    lib.mlspark_gather_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int32,
    ]
    lib.mlspark_text_vocab_create.restype = ctypes.c_int64
    lib.mlspark_text_vocab_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.mlspark_text_vocab_free.restype = None
    lib.mlspark_text_vocab_free.argtypes = [ctypes.c_int64]
    lib.mlspark_text_encode.restype = ctypes.c_int64
    lib.mlspark_text_encode.argtypes = [
        ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


class NativeLibrary:
    """Builds (if stale) and loads the shared library once per process.
    Thread-safe: the first caller builds, others wait; a failure is kept
    and re-raised as ``ImportError`` without another build."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.error: Exception | None = None

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self.error is not None:
                raise ImportError("native library unavailable") from self.error
            so_path = library_path()
            try:
                if not so_path.exists():
                    _build(so_path)
                self._lib = _declare(ctypes.CDLL(str(so_path)))
            except (ImportError, OSError) as e:
                self.error = e
                raise ImportError("native library unavailable") from e
            return self._lib


#: The process's native library, built on first use.
NATIVE = NativeLibrary()


def available() -> bool:
    """True when the native library builds and loads on this host."""
    try:
        NATIVE.load()
        return True
    except ImportError:
        return False


class libsvm_native:
    """Namespace matching the ``data.libsvm`` dispatch hook."""

    @staticmethod
    def parse_text(text: bytes | str) -> tuple[np.ndarray, np.ndarray]:
        lib = NATIVE.load()
        if isinstance(text, str):
            text = text.encode()
        n_rows = ctypes.c_int64()
        n_features = ctypes.c_int64()
        err = ctypes.create_string_buffer(256)
        handle = lib.mlspark_libsvm_parse(
            text, len(text), ctypes.byref(n_rows), ctypes.byref(n_features),
            err, len(err),
        )
        if not handle:
            raise ValueError(err.value.decode() or "libsvm parse failed")
        try:
            features = np.zeros((n_rows.value, n_features.value), dtype=np.float32)
            labels = np.zeros(n_rows.value, dtype=np.float64)
            lib.mlspark_libsvm_copy(
                handle,
                features.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                n_features.value,
            )
        finally:
            lib.mlspark_libsvm_free(handle)
        return features, labels

    @staticmethod
    def parse_file(path: str) -> tuple[np.ndarray, np.ndarray]:
        with open(path, "rb") as f:
            return libsvm_native.parse_text(f.read())


def gather_rows(
    src: np.ndarray, indices: np.ndarray, *, n_threads: int | None = None
) -> np.ndarray:
    """``src[indices]`` for row-major arrays via threaded native memcpy.

    Answers with numpy fancy indexing when the native library is not
    available or the layout is not contiguous."""
    if not np.issubdtype(np.asarray(indices).dtype, np.integer):
        raise IndexError(
            f"gather_rows needs integer indices, got {np.asarray(indices).dtype}"
        )
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    # Object arrays hold PyObject* — memcpy'ing them would skip refcounting
    # and corrupt the interpreter; strided layouts can't be row-memcpy'd.
    if not (src.flags["C_CONTIGUOUS"] and src.ndim >= 1) or src.dtype.hasobject:
        return src[indices]
    if NATIVE.error is not None:
        # A remembered build failure: skip the lock on this per-batch path.
        return src[indices]
    if indices.size and (indices.min() < -len(src) or indices.max() >= len(src)):
        raise IndexError(f"gather index out of range for {len(src)} rows")
    if indices.size and indices.min() < 0:
        indices = np.where(indices < 0, indices + len(src), indices)
    try:
        lib = NATIVE.load()
    except ImportError:
        return src[indices]
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    out = np.empty((len(indices),) + src.shape[1:], dtype=src.dtype)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.mlspark_gather_rows(
        src.ctypes.data_as(ctypes.c_char_p),
        row_bytes,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices),
        out.ctypes.data_as(ctypes.c_char_p),
        n_threads,
    )
    return out


class text_native:
    """C++ batch text encoding (``text_encode.cpp``): tokenize + vocab
    lookup + sos/truncate/eos/pad in one native pass. ASCII-only by
    contract: a caller routes non-ASCII batches to the Python path, whose
    Unicode regex semantics the byte scanner cannot reproduce."""

    MODES = {"basic_english": 0, "word_punct": 1}

    @staticmethod
    def vocab_handle(itos: list[str]) -> int:
        """Register an index-ordered token list; returns a handle for
        ``encode``. The handle is process-local (rebuild after fork)."""
        lib = NATIVE.load()
        blob = "\n".join(itos).encode("utf-8")
        return int(lib.mlspark_text_vocab_create(blob, len(blob)))

    @staticmethod
    def vocab_free(handle: int) -> None:
        try:
            NATIVE.load().mlspark_text_vocab_free(handle)
        except ImportError:
            pass

    @staticmethod
    def encode(
        handle: int,
        texts: list[str],
        *,
        mode: int,
        max_seq_len: int,
        fixed_len: int,
        add_sos: bool,
        add_eos: bool,
        sos_id: int,
        eos_id: int,
        pad_id: int,
        default_index: int,
    ) -> np.ndarray:
        lib = NATIVE.load()
        buf = "".join(texts).encode("ascii")
        offsets = np.zeros(len(texts) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in texts], out=offsets[1:])
        out = np.empty((len(texts), fixed_len), dtype=np.int32)
        rc = lib.mlspark_text_encode(
            handle, buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(texts), mode, max_seq_len, fixed_len,
            int(add_sos), int(add_eos), sos_id, eos_id, pad_id,
            default_index,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc != 0:
            raise RuntimeError(f"mlspark_text_encode failed (rc={rc})")
        return out


__all__ = ["available", "libsvm_native", "gather_rows", "text_native"]
