"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (the entry point
``<name>``, or those ``ENTRY_POINTS`` lists) and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, one
``nvcc`` process per source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \
         csrc/<name>.cu

nvcc's output (ptxas's registers, shared memory and spills of each
kernel) is kept beside the library as ``lib<name>-<hash>.log``.
The hash covers the source, the shared headers and the flags, so an
edited kernel rebuilds.  No ``--use_fast_math``: it would swap ``tanhf`` and the divisions for
approximations and break parity with the plain versions.  A failed build
raises with nvcc's own error.  Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("anomaly_score", "anomaly_fit_step", "anomaly_fit",
           "anomaly_fit_shard")
# The C entry points of a source: its own name, unless listed here
ENTRY_POINTS = {
    "anomaly_fit_shard": ("anomaly_fit_shard_fit",
                          "anomaly_fit_shard_partials",
                          "anomaly_fit_shard_reduce"),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a plain int
# would be cut to 32 bits), cudaError_t returned as int
SIGNATURES = {
    # x, w_enc, b_enc, w_dec, b_dec, out, n, f, stream
    "anomaly_score": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # x, noise, sigma, w_enc, b_enc, w_dec, b_dec, partials,
    # partials_floats, loss_out, lr, n, f, stream
    "anomaly_fit_step": [_P, _P, _F, _P, _P, _P, _P, _P, _L, _P, _F, _I, _I,
                         _P],
    # x, noises, sigma, w_enc, b_enc, w_dec, b_dec, scratch,
    # scratch_floats, losses, lr, n, f, steps, stamps, stamps_len, stream
    "anomaly_fit": [_P, _P, _F, _P, _P, _P, _P, _P, _L, _P, _F, _I, _I, _I,
                    _P, _L, _P],
    # table (shards x 4 int64: x, noise, noise step stride, n_s), shards,
    # sigma, w_enc, b_enc, w_dec, b_dec, scratch, scratch_floats, losses,
    # lr, f, steps, stamps, stamps_len, stream
    "anomaly_fit_shard_fit": [_P, _I, _F, _P, _P, _P, _P, _P, _L, _P, _F, _I,
                              _I, _P, _L, _P],
    # x, noise, sigma, w_enc, b_enc, w_dec, b_dec, slots, slots_floats, n,
    # n_total, f, stream
    "anomaly_fit_shard_partials": [_P, _P, _F, _P, _P, _P, _P, _P, _L, _I,
                                   _I, _I, _P],
    # slots, slots_floats, total_slots, w_enc, b_enc, w_dec, b_dec,
    # loss_out, lr, n_total, f, stream
    "anomaly_fit_shard_reduce": [_P, _L, _I, _P, _P, _P, _P, _P, _F, _I, _I,
                                 _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelCompileError(RuntimeError):
    pass


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise KernelCompileError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    proc.tmp_out = tmp        # type: ignore[attr-defined]
    return proc


def entry_points(source: str) -> tuple[str, ...]:
    return ENTRY_POINTS.get(source, (source,))


_SOURCE_OF = {entry: source for source in SOURCES
              for entry in entry_points(source)}


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for entry in entry_points(name):
        fn = getattr(lib, entry)
        fn.argtypes = SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def build_all(names=SOURCES) -> float:
    """Build (where not built yet) and load every named kernel, running
    one nvcc per source in parallel.  -> seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if n not in _libs]
        paths = {n: _lib_path(n) for n in todo}
        missing = [n for n in todo if not paths[n].exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {n: _start(n, paths[n]) for n in missing}
            errors = []
            for n, proc in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed on csrc/{n}.cu "
                                  f"(exit {proc.returncode}):\n"
                                  f"{log.decode(errors='replace')}")
                else:
                    paths[n].with_suffix(".log").write_bytes(log)
                    os.replace(proc.tmp_out, paths[n])
            if errors:
                raise KernelCompileError("\n".join(errors))
        for n in todo:
            _libs[n] = _load(n, paths[n])
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output from building ``name`` ("" if it was not built here)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def kernel(name: str):
    """The loaded C entry point ``name`` (building its source at first
    use)."""
    source = _SOURCE_OF[name]
    lib = _libs.get(source)
    if lib is None:
        build_all((source,))
        lib = _libs[source]
    return getattr(lib, name)
