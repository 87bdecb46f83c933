#!/usr/bin/env python
"""Where a serving round's time goes in the PyTorch/CUDA port, on the card.

    python tools/torch_serving_profile.py [--kv-int8] [--int8-weights]
                                          [--top 15]

Runs ``chip_smoke.py``'s serving configuration (the 0.44B bf16 Llama,
``ServingConfig`` defaults at max_seq_len 512, the seeded 16-request
trace) through ``paddle_tpu_torch.serving.ServingEngine``, whose phases
run as CUDA graphs captured in ``warmup()`` (the capture time is
printed, and kept out of the timed runs), twice: once with host clocks
around each phase (prefill, plain decode round, verify round — each
ends in the engine's own host sync), and once under ``torch.profiler``
for the device's busy time and the kernels that fill it. Prints one
line per phase, the device-busy share of the profiled wall time, and
the top kernels by device time. Needs a CUDA device.
"""
import argparse
import gc
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import FULL, MAX_SEQ_LEN, _trace, phase_clocks  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import ServingConfig, ServingEngine  # noqa: E402


# kernel families by name: the first whose substring matches
_FAMILIES = (
    ("paged attention (kernels 7, 8)", ("paged_split", "paged_merge")),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
    ("copy and cast", ("copy_kernel", "CatArray")),
    ("gather and index", ("gather", "index")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)


def _engine(model, args):
    """A fresh engine with its phase graphs in place: the first captures
    them, later ones (after the last is collected) take its pools and
    hit the exec cache."""
    gc.collect()
    eng = ServingEngine(model, ServingConfig(
        max_seq_len=MAX_SEQ_LEN, kv_int8=args.kv_int8,
        int8_weights=args.int8_weights))
    eng.warmup()
    return eng


def _timed_run(model, args, trace):
    """Host wall time per phase; each phase ends in a host sync."""
    eng = _engine(model, args)
    spent = phase_clocks(eng)
    for prompt, n in trace:
        eng.submit(prompt, max_new_tokens=n)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, spent, eng.counters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    model = LlamaForCausalLM(LlamaConfig(**FULL), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    trace = _trace()
    t0 = time.perf_counter()
    _timed_run(model, args, trace[:2])  # capture and warm-up
    capture_s = time.perf_counter() - t0
    wall, spent, counters = _timed_run(model, args, trace)
    tokens = sum(n for _, n in trace)
    print(f"card {card}; kv_int8={args.kv_int8} "
          f"int8_weights={args.int8_weights}; {len(trace)} requests, "
          f"{tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tokens/s); "
          f"{counters['graph_replays']} graph replays (captures and the "
          f"2-request warm-up took {capture_s:.2f} s)")
    for phase, (sec, calls) in spent.items():
        print(f"  {phase:8s} {calls:4d} calls  {sec * 1e3:9.1f} ms  "
              f"{sec / max(calls, 1) * 1e3:7.2f} ms/call  "
              f"{sec / wall:6.1%} of wall")
    eng = _engine(model, args)
    for prompt, n in trace:
        eng.submit(prompt, max_new_tokens=n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels are the CUDA-side events; the CPU ops that launched them
    # report the same time again, so count only the former
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled wall {pwall * 1e3:.1f} ms; device busy "
          f"{busy_us / 1e3:.1f} ms = {busy_us / 1e3 / (pwall * 1e3):.1%} "
          f"(idle {1 - busy_us / 1e3 / (pwall * 1e3):.1%}); launches "
          f"{sum(e.count for e in kernels)}")
    # a graph replay records no CPU ops, so group its kernels by name
    families = {}
    for e in kernels:
        fam = next((f for f, keys in _FAMILIES if any(k in e.key
                                                      for k in keys)),
                   "other")
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total
    print("device time by family: " + ", ".join(
        f"{f} {us / 1e3:.1f} ms ({us / busy_us:.1%})" for f, us in
        sorted(families.items(), key=lambda kv: -kv[1])))
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.top, max_name_column_width=140))


if __name__ == "__main__":
    main()
