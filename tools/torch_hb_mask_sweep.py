#!/usr/bin/env python
"""Time the head-batched forward and dQ (kernels 4 and 5) against the key
mask, on the card.

    python tools/torch_hb_mask_sweep.py [--tag T]

At BERT-base's attention shape (b64 s512 h12 d64 bf16, non-causal,
dropout 0.1 with ``chip_smoke.py``'s seed words) times ``hb_fwd`` and
``hb_bwd_dq_delta`` as CUDA-graph replays (``chip_smoke._time_graphs``)
under five key rows: ``bert`` (phase 9's lengths, uniform in 128-512),
``all_live`` (every key live: the key row's cost with nothing skipped),
``len256`` and ``len128`` (every batch row 256 or 128 keys: two and one
of the forward's four 128-key tiles live, four and two of dQ's eight),
and ``none`` (dropout only, no key row); the forward also without
dropout (``bert/nodrop``, ``none/nodrop``). The readings at 128, 256 and
512 live keys give each kernel's cost per live tile column and its fixed
cost. Prints one line per case: ``T fwd/bert: 0.2568 (0.2565-0.2582)
ms``. Runs on the tree it is started from, so two trees compare by
running it from each root, alternately. Needs a CUDA device.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.cuda import head_flash as hf  # noqa: E402

B, S, H, D = 64, 512, 12, 64


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="[mask-sweep]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(2)
    q, k, v, do = cs._flash_inputs(B, S, S, H, H, gen, d=D)
    masks = {"bert": cs._padding_mask(B, S),
             "all_live": cs._padding_mask(B, S, lengths=[S] * B),
             "len256": cs._padding_mask(B, S, lengths=[256] * B),
             "len128": cs._padding_mask(B, S, lengths=[128] * B),
             "none": None}
    fns = {}
    for name, km in masks.items():
        kw = dict(causal=False, kmask=km, seed=cs.ENC_SEED,
                  dropout=cs.ENC_DROPOUT)
        out, lse = hf.hb_fwd(q, k, v, **kw)
        fns[f"fwd/{name}"] = lambda i, kw=kw: hf.hb_fwd(q, k, v, **kw)
        fns[f"dq/{name}"] = lambda i, kw=kw, out=out, lse=lse: \
            hf.hb_bwd_dq_delta(q, k, v, do, out, lse, **kw)
        if name in ("bert", "none"):
            kw0 = dict(kw, dropout=0.0, seed=None)
            fns[f"fwd/{name}/nodrop"] = lambda i, kw=kw0: hf.hb_fwd(
                q, k, v, **kw)
    torch.cuda.synchronize()
    times, _ = cs._time_graphs(fns)
    for name, xs in times.items():
        print(f"{args.tag} {name}: {cs._spread(xs)} ms", flush=True)


if __name__ == "__main__":
    main()
