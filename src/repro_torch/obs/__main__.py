"""``python -m repro_torch.obs summarize <trace.json>`` — per-phase
breakdown of an exported trace, and its structural check (exit 1 on a
structural error).

Stdlib-only: it reads a trace file written on the card, anywhere.
"""
from __future__ import annotations

import argparse
import json
import sys

from .export import format_summary, summarize, validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect exported Chrome trace_event JSON")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sm = sub.add_parser("summarize",
                        help="per-phase time/bytes breakdown of a trace")
    sm.add_argument("trace", help="path to an exported trace JSON")
    sm.add_argument("--json", action="store_true",
                    help="emit the rollup as JSON instead of a table")
    args = ap.parse_args(argv)

    with open(args.trace) as f:
        doc = json.load(f)
    errors = validate_chrome_trace(doc)
    summary = summarize(doc)
    if args.json:
        print(json.dumps({"summary": summary, "structural_errors": errors},
                         indent=1))
    else:
        print(format_summary(summary))
        if errors:
            print(f"\nSTRUCTURAL ERRORS ({len(errors)}):")
            for e in errors:
                print(f"  {e}")
        else:
            print(f"\nstructurally valid "
                  f"({len(doc.get('traceEvents', []))} events)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
