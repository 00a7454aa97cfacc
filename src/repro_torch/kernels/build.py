"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, then loaded with
``ctypes``. Nothing here runs at import: the first kernel call builds its
library (``load``), and ``build_all`` starts every compile at once, one
``nvcc`` per source, for callers that want the whole set up front.

The library name carries a digest of its source, of every header in
``csrc/`` (``hashmix.cuh`` is shared) and of the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is. What
``nvcc`` printed (``-Xptxas -v``: registers, spills and shared memory per
kernel) is kept beside the library under the same name with ``.log``, so
a library built by an earlier process still has its report
(``build_log``). Fast-math is
left off on purpose: the bitset step's decisions divide in float32 and
must round exactly as the reference does (DESIGN §3.4).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("hashmix", "bitset_step", "counter_step", "bloom_probe",
           "scatter_delta")

_lock = threading.Lock()
_libs: dict = {}
# name -> what nvcc printed (registers, shared memory and spills per kernel)
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when the library is current."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        saved = _target(name).with_suffix(".log")
        build_logs.setdefault(name, saved.read_text() if saved.exists()
                              else "(already built)")
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    tmp_log = tmp.with_suffix(".logtmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)


def build_all(names=SOURCES) -> dict:
    """Compile every named source concurrently; returns ``build_logs``."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            _finish(n, job)
    return build_logs


def build_log(name: str) -> str:
    """What ``nvcc`` printed when ``csrc/<name>.cu`` was built, building
    it first if its library is not current."""
    build_all((name,))
    return build_logs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
