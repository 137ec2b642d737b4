#!/usr/bin/env python3
"""Time the port's pixel-diff keep mask on the host and on the card.

    python3 tools/pixel_diff_mask_time.py [--reps 20]

``models/cogreasoner.pixel_diff_keep_mask`` runs on the device of the
rows it is given. This times it on seeded uint8 patch rows at two
shapes: one evaluation turn of the engine phase of ``chip_smoke.py``
(150 frames of 16x26 patches, 104 merged tokens a frame: 62400 rows)
and one streaming-session segment (16 frames of 24x42 patches: 16128
rows), each row 3*14*14 bytes. Routes, each the median wall ms of
``--reps`` calls:

- ``cpu``: numpy rows -> CPU tensor -> mask -> numpy;
- ``card``: rows already on the card -> mask, synchronized;
- ``card_from_host``: numpy rows uploaded -> mask -> numpy (one sync).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = {"engine_turn": (150, 16, 26), "session_segment": (16, 24, 42)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    from cogstream_tpu_torch.models.cogreasoner import pixel_diff_keep_mask

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {}
    rng = np.random.default_rng(0)
    for name, (t, gh, gw) in SHAPES.items():
        merged = (gh // 2) * (gw // 2)
        pv = rng.integers(0, 256, (t * gh * gw, 3 * 14 * 14), np.uint8)
        pv[gh * gw:2 * gh * gw] = pv[:gh * gw]      # one static frame
        minor_h = torch.zeros((t,), dtype=torch.bool)
        pv_d = torch.from_numpy(pv).to(dev)
        minor_d = minor_h.to(dev)

        def on_cpu():
            return pixel_diff_keep_mask(torch.from_numpy(pv), t, merged,
                                        minor_h).numpy()

        def on_card():
            m = pixel_diff_keep_mask(pv_d, t, merged, minor_d)
            torch.cuda.synchronize()
            return m

        def card_from_host():
            return pixel_diff_keep_mask(torch.from_numpy(pv).to(dev), t,
                                        merged, minor_d).cpu().numpy()

        same = bool(np.array_equal(on_cpu(), on_card().cpu().numpy()))
        out[name] = {"rows": int(pv.shape[0]), "frames": t,
                     "cpu_ms": median_ms(on_cpu), "card_ms": median_ms(on_card),
                     "card_from_host_ms": median_ms(card_from_host),
                     "cpu_equals_card": same,
                     "kept": int(on_cpu().sum()), "tokens": t * merged}
    out["torch_threads"] = torch.get_num_threads()
    print(json.dumps(out))
    return 0 if all(v["cpu_equals_card"] for k, v in out.items()
                    if isinstance(v, dict)) else 1


if __name__ == "__main__":
    sys.exit(main())
