#!/usr/bin/env python
"""Time the tile mode's kernels (kernels 1-3 with a tile mask) against
the mask's cell classes, beside the same kernels without a mask, on the
card.

    python tools/torch_tile_mask_sweep.py [--tag T]

At the Transformer decoder's attention shape (b64 s256 h8 d64 bf16,
non-causal, dropout 0.1 and 0) times as CUDA-graph replays
(``chip_smoke._time_graphs``), given the class table and its full-row
flags (so without the class pass): the forward, dQ given delta
(``flash_bwd_dq``'s entry) and dK/dV in the tile mode under three [s, s]
masks, ``zeros`` (every cell ZERO: every pair visited, no mask staged),
``causal`` (the decoder's triangle: 6 of 16 cells DEAD and skipped, 4
MIXED) and ``mixed`` (small random values: every cell MIXED, every mask
tile staged in shared memory), and the same calls without a mask
(``plain``: the non-tile kernels over every pair), and the class pass
alone. ``zeros`` against ``plain`` is what the tile mode costs with
nothing skipped or staged, ``mixed`` against ``zeros`` what staging
costs, ``causal`` against ``zeros`` what skipping gains. The forward also
runs with one block an item (``fwd1``: 1024 blocks of 2-4 key tiles, each
loading its Q before its first tile and storing O and lse after its last)
beside its persistent grid (``fwd``: one block an SM walking the items,
the next item's Q and tiles loaded under the current one's), which is
what a block's fixed cost weighs. Prints the card's name and power
limit, then one line per case: ``T dkv/causal/p0.1: 0.1345
(0.1340-0.1350) ms``. Needs a CUDA device.
"""
import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402

B, S, H, D = 64, 256, 8, 64
SEED = (2025, -18)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="[tile-sweep]")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v, do = cs._flash_inputs(B, S, S, H, H, gen, d=D)
    masks = {
        "zeros": torch.zeros(1, 1, S, S, device="cuda"),
        "causal": torch.triu(torch.full((S, S), fa.NEG_INF, device="cuda"),
                             1)[None, None],
        "mixed": 0.01 * torch.randn(1, 1, S, S, device="cuda",
                                    generator=gen),
    }
    out, lse = fa.flash_fwd(q, k, v, causal=False)
    delta = fa._delta(do, out)
    items = B * H * -(-S // 128)
    fns = {}
    for p in (0.1, 0.0):
        drop = dict(seed=SEED if p else None, dropout=p)
        kw = dict(causal=False, scale=None, window=0, kmask=None,
                  coords=None, **drop)
        fns[f"fwd/plain/p{p}"] = lambda i, kw=kw: fa.flash_fwd(q, k, v, **kw)
        fns[f"dq/plain/p{p}"] = lambda i, kw=kw: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, **kw)
        fns[f"dkv/plain/p{p}"] = lambda i, kw=kw: fa._dkv(
            q, k, v, do, lse, delta, None, tmask=None, tmask_grad=False,
            **kw)
        for name, m in masks.items():
            table = fa.tile_classes(m, S, S, False, full_rows=True)
            kms = fa._tile_args(q, k, None, m, 0)
            for tag, blocks in (("fwd", 0), ("fwd1", items)):
                fns[f"{tag}/{name}/p{p}"] = \
                    lambda i, kw=kw, m=m, t=table, n=blocks: fa._flash_fwd(
                        q, k, v, t, tmask=m, blocks=n, **kw)
            fns[f"dq/{name}/p{p}"] = \
                lambda i, m=m, t=table, kms=kms, p=p: fa._bwd_dq(
                    fa._lib().pt_flash_tile_bwd_dq, "dq", q, k, v, do, lse,
                    delta, (m, t[0], ctypes.addressof(kms)), 1 / D ** 0.5,
                    False, 0, fa._dropout_words(p, SEED if p else None,
                                                None, H))
            fns[f"dkv/{name}/p{p}"] = lambda i, kw=kw, m=m, t=table: fa._dkv(
                q, k, v, do, lse, delta, t, tmask=m, tmask_grad=False, **kw)
    fns["classes/causal"] = lambda i: fa.tile_classes(
        masks["causal"], S, S, False, full_rows=True)
    torch.cuda.synchronize()
    times, _ = cs._time_graphs(fns)
    for name, xs in times.items():
        print(f"{args.tag} {name}: {cs._spread(xs)} ms", flush=True)


if __name__ == "__main__":
    main()
