#!/usr/bin/env python
"""Where a serving round's time goes in the PyTorch/CUDA port, on the card.

    python tools/torch_serving_profile.py [--kv-int8] [--top 15]

Runs ``chip_smoke.py``'s serving configuration (the 0.44B bf16 Llama,
``ServingConfig`` defaults at max_seq_len 512, the seeded 16-request
trace) through ``paddle_tpu_torch.serving.ServingEngine`` twice: once
with host clocks around each phase (prefill, plain decode round, verify
round — each ends in the engine's own host sync), and once under
``torch.profiler`` for the device's busy time and the kernels that fill
it. Prints one line per phase, the device-busy share of the profiled
wall time, and the top kernels by device time. Needs a CUDA device.
"""
import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import FULL, MAX_SEQ_LEN, _trace  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.serving import ServingConfig, ServingEngine  # noqa: E402


def _engine(model, kv_int8):
    return ServingEngine(model, ServingConfig(max_seq_len=MAX_SEQ_LEN,
                                              kv_int8=kv_int8))


def _timed_run(model, kv_int8, trace):
    """Host wall time per phase; each phase ends in a host sync."""
    eng = _engine(model, kv_int8)
    spent = {"prefill": [0.0, 0], "decode": [0.0, 0], "verify": [0.0, 0]}
    for phase, attr in (("prefill", "_prefill"),
                        ("decode", "_plain_decode_round"),
                        ("verify", "_verify_round")):
        inner = getattr(eng, attr)

        def wrapped(*a, _inner=inner, _acc=spent[phase]):
            t0 = time.perf_counter()
            _inner(*a)
            _acc[0] += time.perf_counter() - t0
            _acc[1] += 1

        setattr(eng, attr, wrapped)
    for prompt, n in trace:
        eng.submit(prompt, max_new_tokens=n)
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall, spent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    model = LlamaForCausalLM(LlamaConfig(**FULL), device="cuda",
                             generator=torch.Generator("cuda").manual_seed(0))
    trace = _trace()
    _timed_run(model, args.kv_int8, trace[:2])  # warm-up
    wall, spent = _timed_run(model, args.kv_int8, trace)
    tokens = sum(n for _, n in trace)
    print(f"card {card}; kv_int8={args.kv_int8}; {len(trace)} requests, "
          f"{tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tokens/s)")
    for phase, (sec, calls) in spent.items():
        print(f"  {phase:8s} {calls:4d} calls  {sec * 1e3:9.1f} ms  "
              f"{sec / max(calls, 1) * 1e3:7.2f} ms/call  "
              f"{sec / wall:6.1%} of wall")
    eng = _engine(model, args.kv_int8)
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
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.top, max_name_column_width=60))


if __name__ == "__main__":
    main()
