"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into its own shared
library with a plain ``extern "C"`` interface and loaded with ``ctypes``.
The build runs at first use, one ``nvcc`` per source, all started together,
into the directory that the environment variable ``REPRO_TORCH_BUILD_DIR``
names, or by default ``build/repro_torch_kernels/`` at the root of the
checkout (an installed copy sets the variable to a writable directory).  A library's
file name carries a hash of its sources and flags, so an edit rebuilds it
and an unchanged source is reused.  Nothing here runs at import time.

``LAUNCHES`` holds one plain launch counter per kernel; a wrapper adds one
exactly where it launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"

# library name -> its source; every library also includes the shared headers
SOURCES = {"knn": "knn.cu", "weight": "weight.cu", "near": "near.cu", "far": "far.cu", "far_node": "far_node.cu",
           "naive": "naive.cu", "fused": "fused.cu"}
HEADERS = ("aidw_common.cuh", "aoas.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# extern "C" entry points: name -> (library, argtypes); all return cudaError_t
ENTRY_POINTS = {
    **{f"aidw_knn_alpha_{t}": ("knn", [_P, _P, _P, _P, ctypes.c_longlong, _P] + [_I] * 8 + [_D] * 9 + [_P, _P])
       for t in ("f32", "f64")},
    **{f"aidw_knn_alpha_aoas_{t}": ("knn", [_P] * 3 + [_I] * 7 + [_D] * 9 + [_P, _P]) for t in ("f32", "f64")},
    **{f"aidw_knn_alpha_v2_{t}": ("knn", [_P] * 4 + [_I] * 7 + [_D] * 9 + [_P] * 3) for t in ("f32", "f64")},
    **{f"aidw_weight_{t}": ("weight", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _P, _P])
       for t in ("f32", "f64")},
    **{f"aidw_weight_aoas_{t}": ("weight", [_P] * 4 + [_I] * 4 + [_D, _D, _P, _P]) for t in ("f32", "f64")},
    **{f"aidw_idw_{t}": ("weight", [_P] * 5 + [_I] * 4 + [_D] * 3 + [_P, _P]) for t in ("f32", "f64")},
    **{f"aidw_fused_{t}": ("fused", [_P] * 5 + [_I] * 5 + [_D] * 11 + [_P] * 3) for t in ("f32", "f64")},
    **{f"aidw_naive_soa_{t}": ("naive", [_P] * 5 + [_I] * 5 + [_D] * 11 + [_P] * 3) for t in ("f32", "f64")},
    **{f"aidw_naive_aoas_{t}": ("naive", [_P] * 3 + [_I] * 5 + [_D] * 11 + [_P] * 3) for t in ("f32", "f64")},
    **{f"aidw_near_weight_{t}": ("near", [_P] * 7 + [_I] * 5 + [_D] + [_P] * 5) for t in ("f32", "f64")},
    **{f"aidw_far_cell_{t}": ("far", [_P] * 10 + [_I] * 5 + [_D] + [_P] * 3) for t in ("f32", "f64")},
    **{f"aidw_far_node_{t}": ("far_node", [_P] * 12 + [_I] * 7 + [_D] + [_P] * 3) for t in ("f32", "f64")},
}

# kernel name (the TPU kernel it replaces) -> launches since the last reset
LAUNCHES = {"knn_soa": 0, "knn_skip": 0, "weight_soa": 0, "near_weight": 0, "far_cell": 0, "far_node": 0,
            "naive_soa": 0, "naive_aoas": 0, "knn_aoas": 0, "weight_aoas": 0, "knn_binned": 0,
            "fused": 0, "knn_v2": 0, "idw": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name], *HEADERS):
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Where the libraries are built: ``$REPRO_TORCH_BUILD_DIR`` if set, else
    :data:`DEFAULT_BUILD_DIR`."""
    return Path(os.environ.get(BUILD_DIR_ENV) or DEFAULT_BUILD_DIR)


def library_path(name: str) -> Path:
    return build_dir() / f"libaidw_{name}_{_digest(name)}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / SOURCES[name])]


def build_all() -> dict[str, Path]:
    """Compile every library that is not built yet, all at once; returns
    name -> library path.  Raises ``RuntimeError`` with nvcc's output when a
    build fails.  The ptxas report (registers, spills) of each build is kept
    beside its library as ``<library>.ptxas.txt``."""
    paths = {name: library_path(name) for name in SOURCES}
    if all(p.exists() for p in paths.values()):
        return paths
    if not os.path.exists(nvcc_path()):
        raise RuntimeError(f"nvcc not found (looked for {nvcc_path()}); the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(nvcc_command(name, tmp), stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc for {SOURCES[name]} exited {proc.returncode}:\n{log}")
            continue
        paths[name].with_name(paths[name].name + ".ptxas.txt").write_text(log)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def ptxas_entries() -> list[tuple[str, str, int, int, int]]:
    """Per kernel of the last build of every library, from its ptxas
    report: ``(source, mangled name, registers, spill store bytes, spill
    load bytes)``."""
    out = []
    for name in SOURCES:
        log = library_path(name).with_name(library_path(name).name + ".ptxas.txt")
        if not log.exists():
            continue
        entry, spills = None, (0, 0)
        for ln in log.read_text().splitlines():
            if m := re.search(r"Compiling entry function '([^']+)'", ln):
                entry, spills = m.group(1), (0, 0)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                spills = (int(m.group(1)), int(m.group(2)))
            elif (m := re.search(r"Used (\d+) registers", ln)) and entry is not None:
                out.append((SOURCES[name], entry, int(m.group(1)), *spills))
                entry = None
    return out


def entry(fn_name: str):
    """The ctypes function ``fn_name``, building and loading its library at
    first use."""
    lib_name, argtypes = ENTRY_POINTS[fn_name]
    with _lock:
        if lib_name not in _libs:
            paths = build_all()
            for name, path in paths.items():
                if name not in _libs:
                    _libs[name] = ctypes.CDLL(str(path))
        lib = _libs[lib_name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
