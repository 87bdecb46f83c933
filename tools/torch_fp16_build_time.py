#!/usr/bin/env python
"""Time the build of the flash kernels' two libraries against one source
that holds both 16-bit types.

    python tools/torch_fp16_build_time.py [--rounds N] [--parts]

``csrc/flash_attention.cu`` builds the bf16 and fp32 kernels and
``csrc/flash_attention_fp16.cu`` (the same source with ``PT_FLASH_FP16``)
the float16 ones; ``ops/cuda/_build.py`` builds each apart (each in
the parts of ``_build.PARTS`` as well; this script builds whole
sources), all started together, beside ``paged_attention.cu``. The
alternative is one source whose dispatch instantiates every family at
both bf16 and float16. This script writes that source from
``flash_attention.cu`` (its dispatch macros and the two fused-dQ
entries made to branch on the dtype code, nothing else changed), then
times, with the flags of ``_build.py``:

1. the split build: the two flash sources and the paged source in
   parallel, one ``nvcc`` each;
2. the one-source build: the merged source and the paged source in
   parallel.

The two builds alternate for ``--rounds`` rounds (split, one, one,
split, ...: the host's drift falls on both alike). With ``--parts`` it
times instead ``_build.build()`` itself, with its ``PARTS`` and with
none (one process a source), alternating the same way, each into an
empty directory. Each flash library
must load and export the entries. Prints the card's name and power
limit, each build's wall seconds and kernel count (ptxas's "Compiling
entry function" lines), and the medians. Outputs go under
``paddle_tpu_torch/_build/build_time``. Needs ``nvcc``; the card is only
named.
"""
import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

from paddle_tpu_torch.ops.cuda import _build  # noqa: E402

_FAMILY = r'''// The 16-bit types (bf16 and fp16) with d <= 128 take the tensor-core
// kernels, with d > 128 the fp32-FMA kernels; fp32 (any d) the fp32-FMA
// kernels.
#define PT_FLASH_LOW(T, FN, KM, DROP, ...)                              \
  do {                                                                  \
    if (g.d <= 64) return FN##_tc<T, 64, KM, DROP>(__VA_ARGS__);        \
    if (g.d <= 128) return FN##_tc<T, 128, KM, DROP>(__VA_ARGS__);      \
    return FN<T, 256, 32, 32, KM, DROP>(__VA_ARGS__);                   \
  } while (0)
#define PT_FLASH_FAMILY(FN, KM, DROP, ...)                              \
  do {                                                                  \
    if (dtype == kBFloat16)                                             \
      PT_FLASH_LOW(__nv_bfloat16, FN, KM, DROP, __VA_ARGS__);           \
    if (dtype == kFloat16) PT_FLASH_LOW(__half, FN, KM, DROP, __VA_ARGS__); \
    if (dtype == kFloat32) {                                            \
      if (g.d <= 64) return FN<float, 64, 64, 64, KM, DROP>(__VA_ARGS__); \
      if (g.d <= 128) return FN<float, 128, 64, 64, KM, DROP>(__VA_ARGS__); \
      return FN<float, 256, 32, 32, KM, DROP>(__VA_ARGS__);              \
    }                                                                   \
    return cudaErrorInvalidValue;                                       \
  } while (0)

'''

_TILE = r'''#define PT_TILE_LOW(T, FN, DROP, ...)                                     \
  do {                                                                     \
    if (g.d <= 64) return FN##_tc<T, 64, false, DROP, true>(__VA_ARGS__);  \
    if (g.d <= 128) return FN##_tc<T, 128, false, DROP, true>(__VA_ARGS__); \
    return FN<T, 256, 32, 32, false, DROP, true>(__VA_ARGS__);             \
  } while (0)
#define PT_TILE_FAMILY(FN, DROP, ...)                                        \
  do {                                                                     \
    if (dtype == kBFloat16)                                                \
      PT_TILE_LOW(__nv_bfloat16, FN, DROP, __VA_ARGS__);                   \
    if (dtype == kFloat16) PT_TILE_LOW(__half, FN, DROP, __VA_ARGS__);      \
    if (dtype == kFloat32) {                                               \
      if (g.d <= 64)                                                       \
        return FN<float, 64, 64, 64, false, DROP, true>(__VA_ARGS__);       \
      if (g.d <= 128)                                                      \
        return FN<float, 128, 64, 64, false, DROP, true>(__VA_ARGS__);      \
      return FN<float, 256, 32, 32, false, DROP, true>(__VA_ARGS__);        \
    }                                                                      \
    return cudaErrorInvalidValue;                                          \
  } while (0)

'''


def _cut(src, start, end, new):
    """``src`` with the text from ``start`` up to ``end`` replaced."""
    a = src.index(start)
    return src[:a] + new + src[src.index(end, a):]


def _swap(src, old, new):
    assert src.count(old) == 1, old
    return src.replace(old, new)


def merged(src):
    """flash_attention.cu with every family instantiated at bf16 and
    float16 in one library."""
    src = _cut(src, "// The 16-bit element type of this library.",
               "// ... and the variant: key mask", _FAMILY)
    src = _cut(src, "#ifdef PT_FLASH_FP16\n#define PT_TILE_F32",
               "#define PT_TILE_DISPATCH", _TILE)
    src = _swap(src, "enum { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };\n",
                "enum { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };\n"
                "constexpr bool is_low(int dtype) {\n"
                "  return dtype == kBFloat16 || dtype == kFloat16;\n}\n")
    src = src.replace("dtype != kLowCode", "!is_low(dtype)")
    # the fused-dQ entries: one macro a type, chosen by the dtype code
    for name, args in (("PT_DQ_DELTA", "KM, DROP"),
                       ("PT_TILE_DQ_DELTA", "DROP")):
        src = _swap(src, f"#define {name}({args})",
                    f"#define {name}_T(T, {args})")
        src = _swap(src, f"#undef {name}\n",
                    f"#undef {name}\n#undef {name}_T\n")
        first = src.index(f"  if (", src.index(f"#define {name}_T("))
        src = src[:first] + (
            f"#define {name}({args}) do {{ if (dtype == kFloat16) "
            f"{name}_T(__half, {args}); {name}_T(__nv_bfloat16, {args}); "
            f"}} while (0)\n") + src[first:]
    src = src.replace(", Low>(", ", T>(").replace(", Low, true>(",
                                                  ", T, true>(")
    assert "Low" not in src.split("#define PT_FLASH_LOW")[1], \
        "a Low left in the dispatch"
    return src


def _nvcc(src, out):
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _round(label, sources, out_dir):
    """Build ``sources`` in parallel; print and return the wall seconds."""
    t0 = time.perf_counter()
    procs = {s.stem: (_nvcc(s, out_dir / f"lib{s.stem}.so"), s)
             for s in sources}
    kernels = {}
    for stem, (p, _) in procs.items():
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {stem}:\n{text[-4000:]}")
        kernels[stem] = text.count("Compiling entry function")
    wall = time.perf_counter() - t0
    print(f"{label} build wall {wall:.1f} s; kernels {kernels}", flush=True)
    for s in sources:
        if s.stem.startswith("flash"):
            lib = ctypes.CDLL(str(out_dir / f"lib{s.stem}.so"))
            for e in ("pt_flash_fwd", "pt_hb_bwd_dq_delta",
                      "pt_flash_tile_bwd_dq_delta", "pt_flash_tile_classes"):
                getattr(lib, e)
    return wall


def _parts_round(label, parts, out_dir):
    """``_build.build()`` of every source with ``parts`` as its
    ``PARTS``, into an empty ``out_dir``; print and return the wall
    seconds."""
    shutil.rmtree(out_dir, ignore_errors=True)
    saved = _build.BUILD_DIR, dict(_build.PARTS)
    _build.BUILD_DIR = out_dir
    _build.PARTS.clear()
    _build.PARTS.update(parts)
    try:
        t0 = time.perf_counter()
        libs = _build.build()
        wall = time.perf_counter() - t0
    finally:
        _build.BUILD_DIR = saved[0]
        _build.PARTS.clear()
        _build.PARTS.update(saved[1])
    for name, so in libs.items():
        if name.startswith("flash"):
            lib = ctypes.CDLL(str(so))
            for e in ("pt_flash_fwd", "pt_hb_bwd_dq_delta",
                      "pt_flash_bwd_dkv", "pt_flash_tile_bwd_dkv",
                      "pt_flash_tile_classes"):
                getattr(lib, e)
    print(f"{label} build wall {wall:.1f} s", flush=True)
    return wall


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", action="store_true",
                    help="time _build.build() with its PARTS against one "
                    "process a source")
    args = ap.parse_args()
    rounds = args.rounds
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi or "no card", f"; {os.cpu_count()} CPUs", flush=True)
    out = _build.BUILD_DIR / "build_time"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    if args.parts:
        walls = {"parts": [], "whole": []}
        kinds = {"parts": dict(_build.PARTS), "whole": {}}
        for r in range(rounds):
            for key in ("parts", "whole") if r % 2 == 0 \
                    else ("whole", "parts"):
                walls[key].append(_parts_round(
                    f"{key} ({kinds[key] or 'one process a source'})",
                    kinds[key], out / key))
        parts, whole = (statistics.median(walls[k])
                        for k in ("parts", "whole"))
        print(f"medians of {rounds}: parts {parts:.1f} s, one process a "
              f"source {whole:.1f} s")
        return
    csrc = _build.CSRC
    for f in csrc.iterdir():
        if f.suffix in (".cuh", ".h"):
            shutil.copy(f, out / f.name)
    one = out / "flash_attention_both.cu"
    one.write_text(merged((csrc / "flash_attention.cu").read_text()))
    paged = csrc / "paged_attention.cu"
    builds = {"split": ("split (two flash libraries + paged)",
                        [csrc / "flash_attention.cu",
                         csrc / "flash_attention_fp16.cu", paged]),
              "one": ("one source (bf16 + float16 + fp32, + paged)",
                      [one, paged])}
    walls = {"split": [], "one": []}
    for r in range(rounds):
        for key in ("split", "one") if r % 2 == 0 else ("one", "split"):
            walls[key].append(_round(*builds[key], out))
    split, single = (statistics.median(walls[k]) for k in ("split", "one"))
    print(f"medians of {rounds}: split {split:.1f} s, one source "
          f"{single:.1f} s, one source - split: {single - split:+.1f} s")


if __name__ == "__main__":
    main()
