"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into its own shared library under ``build/repro_torch_kernels/`` at the root
of the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of its source, so an edited source is
rebuilt and an unchanged one is loaded as it is.  nvcc's output (ptxas's
registers, spills and shared memory of every kernel) is kept beside the
library as ``<name>-<hash>.log``, which :func:`ptxas_log` reads.
:func:`build_all` starts one ``nvcc`` per source, all together, and waits
for them.  Nothing here
runs at import time: the CPU tests import every module on machines that
may have neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of every C entry point, by source.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
SIGNATURES = {
    "frame_accum": {
        "frame_accum_i32": [_P, _P, _I, _L, _P],
        "frame_accum_f32": [_P, _P, _I, _L, _P],
        "frame_accum_bf16": [_P, _P, _I, _L, _P],
    },
    "bfs_frontier": {
        "bfs_frontier_f32": [_P, _P, _P, _P, _I, _P, _L, _I, _P, _P, _P],
    },
    "alias_draw": {
        "alias_draw_f32": [_P, _P, _P, _P, _P, _I, _L, _P],
    },
    "flash_attention": {
        "flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LP, _P],
        "flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LP, _P],
    },
    "rglru_scan": {
        "rglru_scan_f32": [_P, _P, _P, _I, _I, _I, _P],
    },
    "ssm_scan": {
        "ssm_scan_f32": [_P, _P, _P, _I, _I, _I, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # toolkit lookup only
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch need "
                       "the CUDA toolkit on PATH or in CUDA_HOME")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def ptxas_log(name: str) -> str:
    """nvcc's output for the built library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def _start(name: str):
    """Start ``nvcc`` for one source unless its library and log exist;
    returns the running process (or None) and the temporary output path."""
    out = library_path(name)
    if out.exists() and out.with_suffix(".log").exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{log}")
    out = library_path(name)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source at once (one ``nvcc`` each, in parallel)."""
    started = {name: _start(name) for name in SIGNATURES}
    errors = []
    for name, (proc, tmp) in started.items():
        try:
            _finish(name, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``argtypes``/``restype`` set on every entry point."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _finish(name, *_start(name))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib
