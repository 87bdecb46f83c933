#!/usr/bin/env python
"""Time the paged decode kernels against their split size, on the card.

    python tools/torch_paged_sweep.py [--tag T] [--split-kb 16 32 64 128]
                                      [--profile]

For bf16 and int8 pools, at ``chip_smoke.py`` phase 3's two shapes (the
served decode geometry, and the long-context one of 2048 slots), checks
``paged_attend`` / ``paged_attend_int8`` against their plain versions,
then times them as CUDA-graph replays (``chip_smoke._time_graphs``, the
per-layer pools cycled) with the K+V bytes per split set to each
``--split-kb`` in turn. Prints one line per dtype and shape: ``T
quant=... M=...: sb32k 10.82us, ...``. With ``--profile`` it also prints
each CUDA kernel's device time per call (split and merge launches) under
``torch.profiler`` at the default split. Runs on the tree it is started
from, so two trees compare by running it from each root, alternately.
Needs a CUDA device.
"""
import argparse
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.cuda import paged_attention as pa  # noqa: E402

LAYERS, NKV, D = 12, 12, 128


def _shape_fns(quant, m, pos, gen):
    """(kernel fn(layer), plain result of layer 0) at one shape."""
    pools, tables = cs._pools(NKV, D, LAYERS, gen, quant, m=m)
    q = torch.randn(cs.LANES, NKV, D, device="cuda",
                    generator=gen).bfloat16()
    pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kern = pa.paged_attend_int8 if quant else pa.paged_attend
    ref = pa.paged_attend_int8_ref if quant else pa.paged_attend_ref
    want = ref(q, *(p[0] for p in pools), tables, pos_t).float()
    return (lambda li: kern(q, *(p[li] for p in pools), tables, pos_t),
            want)


def _profile(fn):
    """Device time per call of each CUDA kernel that ``fn`` launches."""
    for li in range(LAYERS):
        fn(li)
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for li in range(LAYERS):
                fn(li)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.self_device_time_total:
            print(f"    {e.key[:80]}: {e.count // reps // LAYERS} a call, "
                  f"{e.self_device_time_total / e.count:.2f} us each",
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--split-kb", type=int, nargs="+",
                    default=[pa._SPLIT_BYTES // 1024])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    default = pa._SPLIT_BYTES
    gen = torch.Generator("cuda").manual_seed(0)
    for quant in (False, True):
        for m, pos in ((cs.M, cs.POS), (cs.M_LONG, cs.POS_LONG)):
            kern, want = _shape_fns(quant, m, pos, gen)
            fns = {}
            for kb in args.split_kb:
                def fn(i, sb=kb * 1024):
                    pa._SPLIT_BYTES = sb
                    return kern(i % LAYERS)
                err = (fn(0).float() - want).abs().max().item()
                if not err <= cs.BF16_ATOL:
                    raise AssertionError(f"split {kb} KB: max_abs_err {err}")
                fns[f"sb{kb}k"] = fn
            times = cs._time_graphs(fns)
            pa._SPLIT_BYTES = default
            print(f"{args.tag} quant={quant} M={m}: " + ", ".join(
                f"{n} {cs._med(t) * 1e3:.2f}us" for n, t in times.items()),
                flush=True)
            if args.profile:
                _profile(kern)


if __name__ == "__main__":
    main()
