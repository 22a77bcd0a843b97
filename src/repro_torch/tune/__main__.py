"""CLI: sweep and write entries into the port's tuned file.

    PYTHONPATH=src python -m repro_torch.tune --device cpu --scale 7 --scale 12
    PYTHONPATH=src python -m repro_torch.tune --scale 16 --scale 20

Sweeps each scale on the device (the card by default; asking for it
without one raises) and merges the entries into ``--out``: entries for
other (backend, scale) pairs stay, so a card's entries sit beside the CPU
model's.
"""
from __future__ import annotations

import argparse
import json
import sys

from .resolve import TUNED_PATH
from .sweep import autotune, format_entry


def main(argv=None) -> int:
    from ..core.graph import resolve_device
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--scale", type=int, action="append", required=True,
                    help="graph scale(s) to tune at (repeatable)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where to sweep (default: the card)")
    ap.add_argument("--reps", type=int, default=5,
                    help="best-of-N repetitions of the card's timings")
    ap.add_argument("--out", default=TUNED_PATH, metavar="PATH",
                    help="tuned file to merge into (default: the port's)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    try:
        with open(args.out) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {"version": 1, "tool": "python -m repro_torch.tune",
               "entries": []}

    for scale in args.scale:
        entry = autotune(scale, device=device, reps=args.reps)
        doc["entries"] = [e for e in doc.get("entries", [])
                          if (e.get("backend"), e.get("scale"))
                          != (device.type, scale)] + [entry]
        for line in format_entry(entry):
            print(f"[tune] ({device.type}, {scale}) {line}")
        print(f"tuned ({device.type}, scale {scale}): "
              + ", ".join(f"{k}={v}" for k, v in
                          sorted(entry["params"].items())), flush=True)
    doc["entries"].sort(key=lambda e: (e.get("backend", ""),
                                       e.get("scale", 0)))
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
