"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into
``paddle_tpu_torch/_build/lib<name>-<digest>.so``, a shared library
with a plain C interface: one ``nvcc -c`` process a part of the source,
all parts of all sources started together, then one link::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \\
         -Xcompiler -fPIC -Xptxas -v [-DPT_PART=<i>] -c -o <part>.o <name>.cu
    nvcc -shared -o lib<name>-<digest>.so <part>.o ...

No PyTorch header is included, so a build takes seconds. A source has
one part unless ``PARTS`` names it: the flash sources' ``PT_PART``
guards give each part its entry points and the kernels they
instantiate, since their template kernels would otherwise keep one
core busy for minutes. The digest
covers every source and header in ``csrc`` (a source may include
another: ``flash_attention_fp16.cu`` is ``flash_attention.cu`` built at
float16), the flags and the parts, so an edited kernel rebuilds and an
unchanged one is reused. ``-Xptxas -v`` puts each kernel's registers, shared
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

__all__ = ["NVCC_FLAGS", "PARTS", "build", "library", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# sources compiled in parts: name -> number of parts (each source's
# PT_PART guards say which entries a part holds)
PARTS = {"flash_attention": 4, "flash_attention_fp16": 4}

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
    h.update(f"{name} {PARTS.get(name, 1)}".encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    stem = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}"
    return stem.with_suffix(".so"), stem.with_suffix(".log")


def build(names=None) -> dict:
    """Compile ``csrc/<name>.cu`` for each name (all sources when None),
    one ``nvcc -c`` per part of each source (``PARTS``), all started
    together, then one link each. Returns ``{name: path of the .so}``. Raises
    ``RuntimeError`` with the compiler's output if any build fails."""
    if names is None:
        names = sorted(f.stem for f in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, jobs = {}, {}
    for name in names:
        so, log = _paths(name)
        out[name] = so
        if so.exists():
            continue
        # each process writes a private file, renamed into place when
        # done, so concurrent builds never load a half-written library
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        src = str(CSRC / f"{name}.cu")
        parts = [[f"-DPT_PART={i}"] for i in range(PARTS[name])] \
            if name in PARTS else [[]]
        objs = [tmp.with_suffix(f".{i}.o") for i in range(len(parts))]
        procs = [subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *part, "-c", "-o", str(o), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for part, o in zip(parts, objs)]
        jobs[name] = (procs, objs, tmp, so, log)
    errors = []
    for name, (procs, objs, tmp, so, log) in jobs.items():
        texts, failed = [], []
        for i, proc in enumerate(procs):
            text, _ = proc.communicate()
            texts.append(text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu part {i} "
                              f"(exit {proc.returncode}):\n{text}")
        if not failed:
            link = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            texts.append(link.stdout)
            if link.returncode != 0:
                failed.append(f"linking {name}.cu failed (exit "
                              f"{link.returncode}):\n{link.stdout}")
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            errors.extend(failed)
            continue
        log.write_text("".join(texts))
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
