"""One builder for the port's CUDA sources.

Each hand-written kernel library is a ``.cu`` file with a plain C interface
(no PyTorch header, so ``nvcc`` takes seconds), compiled for ``sm_90a`` at
first use into ``build/torch_ext/`` of the checkout and loaded with
``ctypes``.  The shared object's name carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build` starts one ``nvcc`` per missing library, all at once, and
waits for them together.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

#: flags every library is built with (``-Xptxas -v`` reports registers,
#: shared memory and spills into the build log)
BASE_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

#: per library: the nvcc command, its compiler report and the seconds it
#: took, for the builds made in this process
BUILD_LOG: Dict[str, Dict[str, str]] = {}

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class CudaLibrary:
    """A ``.cu`` source and its C entry points.

    ``entry_points`` maps each exported function to its argument types;
    every entry point returns ``cudaGetLastError()`` as an ``int``.
    """
    name: str
    source: Path
    entry_points: Dict[str, Tuple]
    extra_flags: Tuple[str, ...] = ()

    @property
    def flags(self) -> Tuple[str, ...]:
        return BASE_FLAGS + self.extra_flags

    def path(self) -> Path:
        """The shared object for this source and these flags."""
        key = hashlib.sha256(self.source.read_bytes()
                             + " ".join(self.flags).encode()).hexdigest()
        return build_dir() / f"lib{self.name}_{key[:16]}.so"


def build_dir() -> Path:
    """``build/torch_ext`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "torch_ext"


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels cannot be built")


def build(libs: Iterable[CudaLibrary]) -> None:
    """Compile every library whose shared object is missing: one ``nvcc``
    per source, all started together; raises if any of them fails."""
    todo = [lib for lib in libs if not lib.path().exists()]
    if not todo:
        return
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    jobs = []
    for lib in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        log = open(tmp + ".log", "w+")
        cmd = [compiler, *lib.flags, "-o", tmp, str(lib.source)]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((lib, cmd, tmp, log, proc, time.perf_counter()))
    failed = []
    for lib, cmd, tmp, log, proc, t0 in jobs:
        rc = proc.wait()
        seconds = time.perf_counter() - t0
        log.seek(0)
        report = log.read()
        log.close()
        os.unlink(tmp + ".log")
        if rc != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{report}")
            continue
        os.replace(tmp, lib.path())
        BUILD_LOG[lib.name] = {"cmd": " ".join(cmd), "ptxas": report,
                               "seconds": f"{seconds:.1f}"}
    if failed:
        raise RuntimeError("\n".join(failed))


def load(lib: CudaLibrary) -> ctypes.CDLL:
    """Build (if needed) and load ``lib``, with its entry points typed."""
    if lib.name in _loaded:
        return _loaded[lib.name]
    build([lib])
    cdll = ctypes.CDLL(str(lib.path()))
    for fn, argtypes in lib.entry_points.items():
        f = getattr(cdll, fn)
        f.argtypes = list(argtypes) + [ctypes.c_void_p]     # + the stream
        f.restype = ctypes.c_int
    _loaded[lib.name] = cdll
    return cdll


def launch(fn, *args, device: torch.device) -> None:
    """Call a C entry point on ``device``'s current stream; raise on the
    CUDA error it returns (a refused launch never runs, and a later
    synchronise would not report it).  The current device is switched
    only when it is not ``device`` already."""
    raw_stream = torch._C._cuda_getCurrentRawStream
    index, current = device.index, torch.cuda.current_device()
    if index is None or index == current:
        err = fn(*args, raw_stream(current))
    else:
        with torch.cuda.device(index):
            err = fn(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
