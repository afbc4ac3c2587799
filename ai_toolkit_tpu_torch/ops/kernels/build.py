"""Build the port's CUDA kernels and load them with ctypes.

Each ``ai_toolkit_tpu_torch/csrc/<name>.cu`` has a plain C interface and may
include the ``.cuh`` headers beside it. At first use it is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>_<hash>.so`` at the root
of the checkout, where the hash covers the source, the headers and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is. Nothing here runs at import time, and there
is no other way to get a kernel: no nvcc, no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every header of
    ``csrc/`` (a source may include any of them) and the flags."""
    parts = [(CSRC_DIR / f"{name}.cu").read_bytes()]
    parts += [p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def report_path(name: str) -> Path:
    """Where the build of ``name``'s library keeps the compiler's ``-Xptxas
    -v`` report (registers, shared memory and spills of each kernel)."""
    return library_path(name).with_suffix(".ptxas.txt")


def report(name: str) -> str | None:
    """The ``-Xptxas -v`` report of ``name``'s library as built, or None
    where the library was built without one."""
    path = report_path(name)
    return path.read_text() if path.is_file() else None


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the path.

    Every build keeps the compiler's ``-Xptxas -v`` report beside the library
    (:func:`report`); ``verbose`` also prints it."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    text = proc.stdout + proc.stderr
    report_path(name).write_text(text)
    if verbose:
        print(text, flush=True)
    os.replace(tmp, out)
    return out


def build_all(names: list[str], verbose: bool = False) -> dict[str, float]:
    """Build several kernel libraries at once, one ``nvcc`` per source, all
    started together; returns the wall seconds of each build."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name, verbose)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib
