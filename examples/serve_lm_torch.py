"""Batched LM serving on the torch port: prefill + greedy decode against the
mixtral smoke config (MoE + sliding-window attention + ring KV cache),
through ``repro_torch.launch.serve``.  Runs on the card unless given
``--device cpu``; on the card the attention is the B6 kernel.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

``main(argv)`` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.launch import serve


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve.main(["--arch", "mixtral-8x7b", "--smoke", "--batch", "4",
                       "--prompt-len", "48", "--gen", "24",
                       "--device", args.device])


if __name__ == "__main__":
    main()
