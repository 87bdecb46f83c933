#!/usr/bin/env python
"""Where a training step's time goes in the PyTorch/CUDA port, on the card.

    python tools/torch_train_profile.py [--model llama|llama_moe|bert|ernie]
        [--steps 2] [--top 20]

Runs one of ``chip_smoke.py``'s training configurations through
``TrainStep`` with ``AdamW(multi_precision=True)``: the 0.44B bf16
Llama at b8 x s1024 with plain cross-entropy (``llama``, phase 7), the
same with 8 experts a layer, top-2 (``llama_moe``, phase 20a), BERT-base MLM in bf16 O2 with dropout 0.1 on a padded b64 x s512 batch
(``bert``, phase 10), or ERNIE 3.0 joint pretraining at the 10B widths
with the trunk cut to 8 layers, bf16, dropout 0.1, b4 x s1024, the rate
from ``LinearWarmup(PolynomialDecay)`` stepped after each step
(``ernie``, phase 12). Two warm-up steps, then ``--steps`` steps under
``torch.profiler``. Prints the device-busy share of the profiled wall
time, device time by kernel family (the attention kernels, matrix
products, everything else), and the top kernels by device time. Needs a
CUDA device.
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

from chip_smoke import (  # noqa: E402
    BERT_BATCH, BERT_SEQ, ERNIE, ERNIE_BATCH, ERNIE_SEQ, MOE, TRAIN,
    TRAIN_BATCH, TRAIN_SEQ, _train_batch, bert_train_step, ernie_train_step,
)
from paddle_tpu_torch.jit import TrainStep  # noqa: E402
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402

# kernel-name fragments of each family (kernels 4-6 are instances of
# the flash templates; dmask_head_sum is kernel 6's second pass)
FAMILIES = (("attention kernels", ("flash_fwd", "flash_bwd",
                                   "dmask_head_sum")),
            ("matrix products", ("gemm", "xmma", "cutlass", "nvjet")))


def _family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "llama_moe", "bert",
                                        "ernie"), default="llama")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    if args.model == "bert":
        _, _, step, batch = bert_train_step()
        shape = f"BERT-base b{BERT_BATCH} x s{BERT_SEQ}"
    elif args.model == "ernie":
        _, _, sched, train, batch = ernie_train_step()

        def step(*b):
            train(*b)
            sched.step()
        shape = (f"ERNIE-3.0 10B widths, trunk {ERNIE['num_hidden_layers']} "
                 f"of 48, b{ERNIE_BATCH} x s{ERNIE_SEQ}")
    else:
        cfg = LlamaConfig(**(MOE if args.model == "llama_moe" else TRAIN))
        model = LlamaForCausalLM(
            cfg, device="cuda",
            generator=torch.Generator("cuda").manual_seed(0))
        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      parameters=model.parameters(),
                                      multi_precision=True))
        batch = _train_batch(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        shape = (f"{'1.42B MoE' if cfg.moe_num_experts > 1 else '0.44B'} "
                 f"Llama b{TRAIN_BATCH} x s{TRAIN_SEQ}")
    for _ in range(2):
        step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # kernels are the CUDA-side events; the CPU ops that launched them
    # report the same time again, so count only the former
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"card {card}; {args.steps} train steps, {shape}: profiled "
          f"wall {wall_ms:.1f} ms "
          f"({wall_ms / args.steps:.2f} ms/step); device busy "
          f"{busy_ms:.1f} ms = {busy_ms / wall_ms:.1%} (idle "
          f"{1 - busy_ms / wall_ms:.1%}); kernel launches "
          f"{sum(e.count for e in kernels)}")
    by_family = {}
    for e in kernels:
        fam = _family(e.key)
        by_family[fam] = by_family.get(fam, 0.0) \
            + e.self_device_time_total / 1e3
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:18s} {ms / args.steps:9.2f} ms/step  "
              f"{ms / busy_ms:6.1%} of device time")
    print(events.table(sort_by="self_device_time_total",
                       row_limit=args.top, max_name_column_width=60))


if __name__ == "__main__":
    main()
