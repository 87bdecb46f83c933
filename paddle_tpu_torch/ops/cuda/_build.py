"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with its own ``nvcc`` process into
``paddle_tpu_torch/_build/lib<name>-<digest>.so``, a shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<digest>.so <name>.cu

No PyTorch header is included, so a build takes seconds. The digest
covers every source and header in ``csrc`` (a source may include
another: ``flash_attention_fp16.cu`` is ``flash_attention.cu`` built at
float16) and the flags, so an edited kernel rebuilds and an unchanged
one is reused. ``-Xptxas -v`` puts each kernel's registers, shared
memory and spills in ``lib<name>-<digest>.log``. A missing ``nvcc`` or a failed build raises:
there is no fallback. Wrappers declare ``argtypes`` for every entry
point, ``ctypes.c_void_p`` for each pointer and the stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "library", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use")


def _paths(name: str):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    stem = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def build(names=None) -> dict:
    """Compile ``csrc/<name>.cu`` for each name (all sources when None),
    one ``nvcc`` per source, all started together. Returns ``{name:
    path of the .so}``. Raises ``RuntimeError`` with the compiler's
    output if any build fails."""
    if names is None:
        names = sorted(f.stem for f in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        so, log = _paths(name)
        out[name] = so
        if so.exists():
            continue
        # each process writes a private file, renamed into place when
        # done, so concurrent builds never load a half-written library
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, so, log)
    errors = []
    for name, (proc, tmp, so, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def ptxas_report(name: str) -> list:
    """ptxas's resource lines (registers, shared memory, spills) for
    ``csrc/<name>.cu``, from its last build's log."""
    _, log = _paths(name)
    if not log.exists():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "ptxas info" in ln or "spill" in ln]
