"""Native (C++) host data-path library, built on demand with g++.

Counterpart of ``skyplane_tpu/native/__init__.py``: the same two sources
(``datapath.cpp``, ``skylz.cpp``, the port's own copies), the same C symbols
and ctypes signatures. The library is built into ``build/skyplane_tpu_torch/``
(``SKYPLANE_TPU_NATIVE_BUILD_DIR`` relocates it) as ``libskydp-<hash>.so``;
the hash covers the sources, the compiler flags and a host tag (the machine
and its CPU flags), because an ``-march=native`` build must never be loaded on
another CPU. Each build compiles to a private temporary name and is renamed
into place, so processes building at once never load a torn file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from skyplane_tpu_torch.exceptions import MissingDependencyException

SRC_DIR = Path(__file__).parent
SOURCES = ("skylz.cpp", "datapath.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "skyplane_tpu_torch"  # the CUDA kernels build here too
NATIVE_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
PORTABLE_FLAGS = ("-O3", "-shared", "-fPIC")  # when -march=native does not compile (emulated CPUs)

_BUILD_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: how the loaded library came to be: path, build seconds (0.0 when found
#: built), and whether it is the -march=native build
build_info: dict = {}


def _build_dir() -> Path:
    override = os.environ.get("SKYPLANE_TPU_NATIVE_BUILD_DIR")
    return Path(override) if override else BUILD_DIR


def host_tag() -> str:
    """The machine and a digest of its CPU feature flags (``/proc/cpuinfo``)."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        pass
    return f"{platform.machine()}-{hashlib.sha256(flags.encode()).hexdigest()[:12]}"


def library_path(flags=NATIVE_FLAGS, tag: Optional[str] = None) -> Path:
    """Where the library built with ``flags`` on host ``tag`` (default: this host) lives."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((host_tag() if tag is None else tag).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return _build_dir() / f"libskydp-{h.hexdigest()[:16]}.so"


def _compile(flags, out: Path) -> Optional[str]:
    """Build into ``out`` through a private temporary file; the compiler's
    output on failure, None on success."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *flags, *(str(SRC_DIR / s) for s in SOURCES), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except FileNotFoundError as e:
        raise MissingDependencyException("the native library needs g++ in PATH") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr[-2000:]
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, restype, argtypes in (
        ("skylz_max_compressed_size", ctypes.c_uint64, [ctypes.c_uint64]),
        ("skylz_compress", ctypes.c_uint64, [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]),
        ("skylz_decompressed_size", ctypes.c_uint64, [ctypes.c_char_p, ctypes.c_uint64]),
        ("skylz_decompress", ctypes.c_uint64, [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]),
        ("skylz_checksum64", ctypes.c_uint64, [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64]),
        ("skydp_gear_candidates", None, [u8p, ctypes.c_uint64, u32p, ctypes.c_uint32, u8p]),
        ("skydp_segment_fp", None, [u8p, ctypes.c_uint64, i64p, ctypes.c_uint64, u32p, u32p]),
        (
            "skydp_cdc_fp",
            ctypes.c_uint64,
            [u8p, ctypes.c_uint64, u32p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64, u32p, i64p, u32p, ctypes.c_uint64],
        ),
        ("skydp_blockpack_encode", ctypes.c_uint64, [u8p, ctypes.c_uint64, ctypes.c_uint64, u8p, u8p]),
        ("skydp_blockpack_decode", ctypes.c_int, [u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, ctypes.c_uint64, u8p]),
    ):
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load libskydp: the ``-march=native`` build, or the
    portable one when that does not compile. Raises
    ``MissingDependencyException`` without g++ or when neither build compiles."""
    global _lib
    if _lib is not None:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        native, portable = library_path(NATIVE_FLAGS), library_path(PORTABLE_FLAGS)
        out = native if native.exists() else portable if portable.exists() else None
        if out is None:
            err = _compile(NATIVE_FLAGS, native)
            out = native
            if err is not None:
                err2 = _compile(PORTABLE_FLAGS, portable)
                if err2 is not None:
                    raise MissingDependencyException(f"native library build failed: {err2}")
                out = portable
            seconds = time.perf_counter() - t0
        else:
            seconds = 0.0
        lib = ctypes.CDLL(str(out))
        _bind(lib)
        build_info.update(path=str(out), seconds=seconds, march_native=out == native)
        _lib = lib
        return _lib
