"""Build the port's CUDA sources into shared libraries with ``nvcc`` at
first use, and load them with ``ctypes``.

Each library exports plain C functions (no PyTorch headers), so a build
takes seconds.  Libraries go to ``build/torch_ext/`` at the repository
root (listed in ``.gitignore``), or to ``$REPRO_TORCH_BUILD_DIR``; a
library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and never mistaken for a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))

NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: library name -> its CUDA sources (paths relative to this package).
SOURCES = {
    "sbts_step": ("sbts_step/csrc/selection_counts.cu",),
    "mma_probe": ("sbts_step/csrc/mma_probe.cu",),
    "conflict_matrix": ("conflict_matrix/csrc/conflict_matrix.cu",),
    "flash_attention": ("flash_attention/csrc/flash_attention.cu",),
    "flash_attention_tc": ("flash_attention/csrc/flash_attention_tc.cu",),
    "ssd": ("ssd/csrc/ssd.cu",),
    "ssd_tc": ("ssd/csrc/ssd_tc.cu",),
    "ssd_bwd": ("ssd/csrc/ssd_bwd.cu",),
    "ssd_bwd_tc": ("ssd/csrc/ssd_bwd_tc.cu",),
    "ragged_dot": ("ragged_dot/csrc/ragged_dot.cu",),
    "ragged_dot_bwd": ("ragged_dot/csrc/ragged_dot_bwd.cu",),
    "flash_attention_bwd": ("flash_attention/csrc/flash_attention_bwd.cu",),
}

#: library name -> headers its sources include, hashed with them so an
#: edited header rebuilds the library.
HEADERS = {
    "sbts_step": ("sbts_step/csrc/wgmma_s32.cuh", "csrc/sm90.cuh"),
    "mma_probe": ("sbts_step/csrc/wgmma_s32.cuh", "csrc/sm90.cuh"),
    "flash_attention": ("csrc/tf32_mma.cuh", "csrc/sm90.cuh"),
    "flash_attention_tc": ("csrc/sm90.cuh",),
    "ssd": ("csrc/tf32_mma.cuh", "csrc/sm90.cuh"),
    "ragged_dot": ("csrc/sm90.cuh", "csrc/mma_bf16.cuh",
                   "csrc/wgmma_bf16.cuh", "csrc/tf32_mma.cuh",
                   "ragged_dot/csrc/ragged_items.cuh",
                   "ragged_dot/csrc/ragged_tc.cuh",
                   "ragged_dot/csrc/ragged_tf32.cuh"),
    "ragged_dot_bwd": ("csrc/sm90.cuh", "csrc/mma_bf16.cuh",
                       "csrc/wgmma_bf16.cuh", "csrc/tf32_mma.cuh",
                       "ragged_dot/csrc/ragged_items.cuh",
                       "ragged_dot/csrc/ragged_tc.cuh",
                       "ragged_dot/csrc/ragged_tf32.cuh"),
    "flash_attention_bwd": ("csrc/sm90.cuh", "csrc/tf32_mma.cuh",
                            "csrc/wgmma_bf16.cuh"),
    "ssd_bwd": ("csrc/tf32_mma.cuh", "csrc/sm90.cuh",
                "ssd/csrc/ssd_bwd_common.cuh"),
    "ssd_bwd_tc": ("csrc/sm90.cuh", "ssd/csrc/ssd_bwd_common.cuh"),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> str:
    return os.environ.get("REPRO_TORCH_BUILD_DIR",
                          os.path.join(_REPO, "build", "torch_ext"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def _target(name: str) -> tuple[str, list[str]]:
    srcs = [os.path.join(_HERE, s) for s in SOURCES[name]]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(_HERE, s) for s in HEADERS.get(name, ())]:
        with open(s, "rb") as fh:
            h.update(fh.read())
    so = os.path.join(build_dir(), f"{name}-{h.hexdigest()[:12]}.so")
    return so, srcs


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists.  Returns
    (library path, temporary output, process), the last two None when
    there is nothing to build."""
    so, srcs = _target(name)
    if os.path.exists(so):
        return so, None, None
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, tmp, proc


def build_all(names=None) -> dict[str, str]:
    """Build every library in ``names`` (default: all), one ``nvcc``
    per library, all started together.  Returns name -> library path.
    The compiler's output is kept beside each library (``.so.log``)."""
    names = list(SOURCES if names is None else names)
    with _LOCK:
        started = {n: _start(n) for n in names}
        failed = []
        for n, (so, tmp, proc) in started.items():
            if proc is None:
                continue
            log, _ = proc.communicate()       # wait for every nvcc
            with open(f"{so}.log", "w") as fh:
                fh.write(log)
            if proc.returncode == 0:
                os.replace(tmp, so)
            else:
                failed.append(f"nvcc failed for {n} "
                              f"(exit {proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
    return {n: so for n, (so, _, _) in started.items()}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills) from the build of ``name``, or '' if it was not built here."""
    so, _ = _target(name)
    try:
        with open(f"{so}.log") as fh:
            return fh.read()
    except FileNotFoundError:
        return ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        so = build_all([name])[name]
        with _LOCK:
            lib = _LIBS.setdefault(name, ctypes.CDLL(so))
    return lib
