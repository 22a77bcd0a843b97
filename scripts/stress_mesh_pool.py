"""Run the 4-rank gloo pool of ``tests/test_torch_mesh_train.py`` again and
again under the tier-1 suite's command shape (``-n 6 --dist loadfile``,
other port modules beside it) and record, per run, whether the pool
stalled.

A stall is intermittent, so one passing run proves nothing: this runs
``--runs`` times and writes one JSON line per run to ``--out``: the exit
code, the wall seconds, the module's passes and errors, and whether the
pool failed (``spawn``'s "did not finish within", a collective that timed
out or lost its peer, or any error of the module) with the first lines of
that error.

  PYTHONPATH=src python scripts/stress_mesh_pool.py --root . --runs 10 \\
      --out build/stress.jsonl

``--root`` is the checkout to run in (another commit unpacked under
``build/`` compares a parent with this tree).

``--micro ROUNDS`` runs instead, with ``--root``'s ``launch.mesh``, the
call pattern every recorded stall sat in, alone: 4 gloo ranks as a (2, 2)
grid repeat a world barrier, a few milliseconds of file work on rank 0
(an async checkpoint's write), a second world barrier and an all-to-all
on the flat sub-mesh (the step's DGAS exchange), ``--runs`` pools of
ROUNDS rounds; a pool that outlives ``--limit`` is a stall.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

MODULE = "tests/test_torch_mesh_train.py"
# port modules that load the other workers as the whole suite does
# (the multi-rank pools and the heaviest parity modules)
BESIDE = ["tests/test_torch_mesh_lm.py", "tests/test_torch_distributed.py",
          "tests/test_torch_dist_more.py", "tests/test_torch_models.py",
          "tests/test_torch_train.py", "tests/test_torch_gnn.py",
          "tests/test_torch_batched.py", "tests/test_torch_structured.py"]
# a stalled pool ("did not finish"), a named collective that outlived its
# timeout, or a peer gone while a collective waited (an error line, not
# the source lines a traceback quotes)
STALL = re.compile(r"Error: (the ranks did not finish within|.*failed after"
                   r"|.*Connection closed by peer|.*[Tt]imed out)")


def one_run(root: str, i: int, workers: int, limit: float,
            work: str) -> dict:
    xml = os.path.join(work, f"run{i}.xml")
    log = os.path.join(work, f"run{i}.log")
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-p", "xdist", "-n", str(workers), "--dist", "loadfile",
           "-p", "no:randomly", f"--junitxml={xml}", MODULE] + BESIDE
    t0 = time.monotonic()
    with open(log, "w") as f:
        try:
            rc = subprocess.run(cmd, cwd=root, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=limit).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    wall = time.monotonic() - t0
    rec = {"run": i, "rc": rc, "wall_s": round(wall, 1), "passed": 0,
           "errors": 0, "failures": 0, "module_s": 0.0}
    if os.path.exists(xml):
        for case in ET.parse(xml).getroot().iter("testcase"):
            if "test_torch_mesh_train" not in case.get("classname", ""):
                continue
            rec["module_s"] += float(case.get("time", 0))
            if case.find("error") is not None:
                rec["errors"] += 1
            elif case.find("failure") is not None:
                rec["failures"] += 1
            elif case.find("skipped") is None:
                rec["passed"] += 1
    rec["module_s"] = round(rec["module_s"], 1)
    text = open(log, errors="replace").read()
    hits = [ln for ln in text.splitlines() if STALL.search(ln)]
    rec["stalled"] = bool(hits) or rc == 124 or rec["errors"] > 0
    rec["stall_lines"] = hits[:6]
    return rec


def micro_rank(mesh, rounds: int, work: str) -> int:
    """One rank of the ``--micro`` pattern; returns the rounds done."""
    import torch
    flat = mesh.over(("data", "model"))
    x = torch.arange(4 * 64, dtype=torch.float32)
    for i in range(rounds):
        mesh.barrier()
        if mesh.rank == 0:
            with open(os.path.join(work, "leaf.bin"), "wb") as f:
                f.write(os.urandom(1 << 16))
        mesh.barrier()
        flat.all_to_all(x)
    return rounds


def micro(root: str, i: int, rounds: int, limit: float, work: str) -> dict:
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.launch import mesh as M
    init = os.path.join(work, f"micro{i}.init")
    t0 = time.monotonic()
    rec = {"run": i, "rounds": rounds, "stalled": False, "stall_lines": []}
    try:
        M.spawn(micro_rank, 4, device="cpu", init_file=init,
                grid=((2, 2), ("data", "model")), args=(rounds, work),
                timeout=limit)
    except RuntimeError as e:
        rec["stalled"] = True
        rec["stall_lines"] = [ln for ln in str(e).splitlines()
                              if STALL.search(ln) or "in barrier" in ln
                              or "in all_to_all" in ln][:12]
    rec["wall_s"] = round(time.monotonic() - t0, 1)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--limit", type=float, default=1500.0,
                    help="seconds a run may take before it is cut")
    ap.add_argument("--out", required=True)
    ap.add_argument("--micro", type=int, default=0, metavar="ROUNDS",
                    help="run the barrier / all-to-all pattern alone")
    args = ap.parse_args(argv)
    work = os.path.abspath(args.out) + ".d"
    os.makedirs(work, exist_ok=True)
    recs = []
    for i in range(args.runs):
        if args.micro:
            rec = micro(os.path.abspath(args.root), i, args.micro,
                        args.limit, work)
        else:
            rec = one_run(os.path.abspath(args.root), i, args.workers,
                          args.limit, work)
        recs.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    print(f"{sum(r['stalled'] for r in recs)} of {len(recs)} runs stalled")
    return recs


if __name__ == "__main__":
    main()
