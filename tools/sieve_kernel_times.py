#!/usr/bin/env python3
"""Time one tree's B5 (`gram_sieve_rows`) and B6 (`lut_sieve`) on the
inputs that `chip_smoke.py --keep-inputs PATH` kept (keys `sieve_*`): B5 on
seeded rows [4096, 4096] and [512, 4096] in raw bytes and in the auto
codec's class ids and on B6's tiles in raw bytes, B6 on 4,096 packed tiles
of 4,096 bytes with the builtin LUT.

    PYTHONPATH=<tree> python3 tools/sieve_kernel_times.py PATH LABEL [--byte-order]

`trivy_tpu_torch` comes from <tree> (this checkout, or an earlier commit
unpacked with `git archive`), which builds its own kernels.  The tree's
sieve objects (`RowGramSieve`, `LutSieve`) are built from the kept gram
constants and LUT once, outside the timing.  One JSON line per input: the
kernel, its shape, the CUDA-event median of 20 calls (host launch work
included), the profiler's device time per call (the tree's sieve kernels
and memsets) and a digest of the output (after a second of matrix
products, so the card's clock is up), so two trees can be timed on one
card in one call (in turns: old, new, new, old) and their outputs checked
equal.  `--byte-order` numbers the byte classes of both kernels' tables by
byte value instead of `gram_sieve.SYMBOL_ORDER` (frequent text bytes
first), to time what that order buys.  Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import json
import sys

import numpy as np
import torch

from nfa_kernel_times import device_ms, event_ms, warm_up

# B5 and B6 in the first-cut and the current sources, and memsets
NAMES = ("gram_sieve_kernel", "gram_rows_kernel", "lut_sieve_kernel", "lut_class_kernel",
         "Memset")


def main(path: str, label: str, byte_order: bool = False) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from trivy_tpu_torch.ops import gram_sieve as gs
    from trivy_tpu_torch.ops import lut_sieve as ls

    if byte_order:
        gs.SYMBOL_ORDER = np.arange(256)
    kept = {k: v for k, v in torch.load(path).items() if k.startswith("sieve_")}
    if not kept:
        print(f"{path} holds no sieve inputs", file=sys.stderr)
        return 1
    warm_up()
    for key, value in kept.items():
        if key.startswith("sieve_b5"):
            rows, masks, vals = value
            sieve = gs.RowGramSieve(masks.numpy().astype("uint32"),
                                    vals.numpy().astype("uint32"), device="cuda")
            kernel, data = "gram_sieve_rows", rows.cuda()
        else:
            tiles, lut = value
            sieve = ls.LutSieve(lut.numpy().astype("uint32"), device="cuda")
            kernel, data = "lut_sieve", tiles.cuda()
        out = sieve(data)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = event_ms(lambda: sieve(data))
        dev = device_ms(lambda: sieve(data), NAMES)
        print(json.dumps({"tree": label, "byte_order": byte_order, "input": key, "kernel": kernel,
                          "shape": list(data.shape), "ms": round(ms, 5),
                          "device_ms": None if dev is None else round(dev, 5),
                          "out": digest, "card": torch.cuda.get_device_name(0)}),
              flush=True)
    return 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--byte-order"]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(*args, byte_order="--byte-order" in sys.argv))
