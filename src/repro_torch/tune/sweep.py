"""The port's autotuner: sweep the grids, pick winners, emit tuned entries
(counterpart of ``repro.tune.sweep``).

Two regimes, chosen by the device the sweep runs on:

* **card** (``device.type == "cuda"``): each BBCSR candidate is built on
  the swept graph itself, run once through the port's CUDA kernel (B1
  ``spmv_dma`` for 'add', B3 ``spmspv_dma`` 'min' on an every-7th-vertex
  frontier) and held to the default geometry's output bit for bit, then
  timed with CUDA events, best of ``reps`` runs of ``_LAUNCHES`` launches
  after a warm-up.  Only the operand being timed lives on the card.
* **CPU**: the reference's deterministic cost models, function for
  function: the stream bytes of a geometry, the sparse path's traffic
  replayed over a BFS's real frontiers, the routed-byte replay of the
  engine knobs, measured SSSP iteration counts and the lane-amortization
  model of the service's budget.  The gate compares the plain versions on
  a probe of scale <= 8.  They add in float64, so they admit 'add'
  geometries that the reference's interpret-mode gate (the Pallas order)
  rejects.

Either way the incumbent default competes and survives anything short of
a ``space.HYSTERESIS`` win, and a kernel candidate counts only when it is
admitted: min / max are exact in any order, but an 'add' geometry that
re-associates the f32 sums is dropped, so tuning never changes a bit.
"""
from __future__ import annotations

import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import space
from .resolve import resolve

__all__ = ["autotune", "kernel_rows", "stream_peak_bytes_per_s",
           "bbcsr_stream_bytes", "probe_graph", "bfs_level_sets",
           "format_entry"]

# launches per timed run on the card (each best-of rep times this many)
_LAUNCHES = 10


# ---------------------------------------------------------------------------
# Probe machinery (host side, deterministic)
# ---------------------------------------------------------------------------

def probe_graph(scale: int, device="cuda"):
    """The sweep's input class: weighted RMAT at Graph500 skew, seed 0."""
    from ..core.graph import rmat
    return rmat(scale, 8, seed=0, device=device)


def _host_adjacency(csr) -> Tuple[np.ndarray, np.ndarray]:
    return (csr.indptr.cpu().numpy().astype(np.int64),
            csr.indices.cpu().numpy())


def _neighbours(indptr: np.ndarray, indices: np.ndarray,
                frontier: np.ndarray) -> np.ndarray:
    """The distinct out-neighbours of ``frontier``, sorted."""
    lo = indptr[frontier]
    cnt = indptr[frontier + 1] - lo
    total = int(cnt.sum())
    pos = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(total)
    return np.unique(indices[pos])


def _bfs_levels(indptr, indices, n: int, source: int) -> List[np.ndarray]:
    seen = np.zeros(n, bool)
    seen[source] = True
    frontier = np.array([source], np.int64)
    out = []
    while frontier.size:
        out.append(frontier)
        nbr = _neighbours(indptr, indices, frontier)
        frontier = nbr[~seen[nbr]]
        seen[frontier] = True
    return out


def bfs_level_sets(csr) -> List[np.ndarray]:
    """Per-level frontier vertex sets of a source-0 BFS, in numpy: the
    activity profile the traffic models replay."""
    indptr, indices = _host_adjacency(csr)
    return _bfs_levels(indptr, indices, csr.n_rows, 0)


def _eccentricities(csr, sources: Sequence[int]) -> List[int]:
    indptr, indices = _host_adjacency(csr)
    return [len(_bfs_levels(indptr, indices, csr.n_rows, int(s)))
            for s in sources]


def _pick(table: List[Tuple[dict, float]]) -> dict:
    """Hysteresis winner: table[0] is the incumbent default; a challenger
    must beat it by more than space.HYSTERESIS of its cost."""
    default_cfg, default_cost = table[0]
    best_cfg, best_cost = default_cfg, default_cost
    for cfg, cost in table[1:]:
        if cost < best_cost:
            best_cfg, best_cost = cfg, cost
    if best_cost < default_cost * (1.0 - space.HYSTERESIS):
        return best_cfg
    return default_cfg


def _best_of_cuda(fn, reps: int) -> float:
    """Microseconds a call: CUDA events around _LAUNCHES calls, best of
    ``reps`` runs, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(_LAUNCHES):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / _LAUNCHES)
    return best * 1e3


def _best_of_host(fn, reps: int) -> float:
    """Microseconds a call on the host clock, best of ``reps``, after one
    warm-up call (the CPU regime: plain versions)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _best_of(fn, reps: int, device: torch.device) -> float:
    return _best_of_cuda(fn, reps) if device.type == "cuda" else \
        _best_of_host(fn, reps)


# ---------------------------------------------------------------------------
# BBCSR kernel geometry: stream-byte model, gate, timing
# ---------------------------------------------------------------------------

def bbcsr_stream_bytes(bb) -> int:
    """Modeled bytes one full SpMV streams: every tile's (rows, cols,
    vals) triple, one x-block fetch per tile, and the y blocks written
    back.  Padding is real traffic, so fuller tiles win."""
    per_tile = bb.tile_nnz * (4 + 4 + 4) + bb.block_cols * 4
    n_rb = -(-bb.n_rows // bb.block_rows)
    return bb.n_tiles * per_tile + n_rb * bb.block_rows * 4


def _spmspv_stream_bytes(bb, level_sets: List[np.ndarray]) -> int:
    """The sparse path's traffic over a BFS: per level, only the tiles
    whose column block holds an active source, from the probe's real
    frontier sets."""
    tile_cb = bb.tile_cb.cpu().numpy()
    per_tile = bb.tile_nnz * (4 + 4 + 4) + bb.block_cols * 4
    n_rb = -(-bb.n_rows // bb.block_rows)
    y_bytes = n_rb * bb.block_rows * 4
    total = 0
    for frontier in level_sets:
        active_cb = np.unique(frontier // bb.block_cols)
        active_tiles = int(np.isin(tile_cb, active_cb).sum())
        total += active_tiles * per_tile + y_bytes
    return total


def _operand_gb(bb) -> float:
    """The operand's device bytes, in 1e9."""
    tensors = (bb.rows_local, bb.cols_local, bb.vals, bb.tile_rb, bb.tile_cb,
               bb.tile_init, bb.tile_cnt, bb.rb_ptr)
    return sum(t.numel() * t.element_size() for t in tensors) / 1e9


def _inputs(n: int, combine: str, device):
    """The sweep's kernel inputs: x ~ U[0, 1) from default_rng(0) for
    'add'; for 'min' every 7th vertex active, x there and +inf elsewhere."""
    rng = np.random.default_rng(0)
    x = rng.random(n, np.float32)
    if combine == "add":
        return torch.from_numpy(x).to(device), None
    frontier = np.zeros(n, np.int32)
    frontier[::7] = 1
    x = np.where(frontier > 0, x, np.inf).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(frontier).to(device))


def _runner(bb, combine: str, x, frontier):
    """The product the family runs, as a call with no arguments: the CUDA
    kernel on a card, its plain version on the CPU."""
    from ..core import engine
    from ..kernels import ops
    if combine == "add":
        return lambda: ops.spmv_dma(bb, x)
    active = engine.tile_active(bb, frontier)
    return lambda: ops.spmspv_dma(bb, x, active, combine="min")


def _sweep_bbcsr(section: str, csr, scale: int, level_sets, reps: int):
    """(table of admitted [cfg, cost], extra score keys) for one kernel
    family; see the module docstring for the two regimes."""
    from ..core.graph import to_bbcsr
    combine = "add" if section.endswith("add") else "min"
    card = csr.device.type == "cuda"
    t = csr.transpose()
    t_gate = t if card or scale <= 8 else \
        probe_graph(8, device=csr.device).transpose()
    x, frontier = _inputs(t_gate.n_rows, combine, t_gate.device)
    want = None
    table, rejected, gb = [], [], []
    for cfg in space.kernel_grid(section):
        bb = to_bbcsr(t_gate, **cfg)
        run = _runner(bb, combine, x, frontier)
        got = run()
        want = got if want is None else want
        admitted = torch.equal(got, want)
        if card:
            gb.append([cfg, _operand_gb(bb)])
            (table if admitted else rejected).append(
                [cfg, _best_of_cuda(run, reps)])
        elif admitted:
            model = bb if t_gate is t else to_bbcsr(t, **cfg)
            table.append([cfg, float(
                bbcsr_stream_bytes(model) if combine == "add"
                else _spmspv_stream_bytes(model, level_sets))])
        del bb, run, got
        if card:
            torch.cuda.empty_cache()
    extra = {"rejected": rejected, "operand_gb": gb} if card else {}
    return table, extra


# ---------------------------------------------------------------------------
# Engine / SSSP / service models
# ---------------------------------------------------------------------------

def _route_cost(level_sets, deg: np.ndarray, n: int, m: int,
                switch_frac: float, slack: float) -> float:
    """Per BFS level: compacted-capacity routing while the frontier fits
    ``switch_frac * n`` (full routing when its edges overflow the
    capacity), a dense pull otherwise."""
    from ..core import engine
    cap = engine.frontier_edge_capacity(m, switch_frac, slack=slack)
    cost = 0.0
    for frontier in level_sets:
        edges = float(deg[frontier].sum())
        if frontier.size <= n * switch_frac:
            cost += cap if edges <= cap else m
        else:
            cost += m
    return cost


def _sweep_engine(csr, level_sets) -> Dict[str, float]:
    deg = np.diff(csr.indptr.cpu().numpy().astype(np.int64))
    n, m = csr.n_rows, csr.nnz
    slack0 = space.DEFAULTS["engine.push_slack"]
    table = [({"switch_frac": f},
              _route_cost(level_sets, deg, n, m, f, slack0))
             for f in space.GRIDS["engine"]["switch_frac"]]
    # the grid's order is not default-first: rotate the incumbent forward
    table.sort(key=lambda t: t[0]["switch_frac"]
               != space.DEFAULTS["engine.switch_frac"])
    f_win = _pick(table)["switch_frac"]
    stable = [({"push_slack": s},
               _route_cost(level_sets, deg, n, m, f_win, s))
              for s in space.GRIDS["engine"]["push_slack"]]
    stable.sort(key=lambda t: t[0]["push_slack"]
                != space.DEFAULTS["engine.push_slack"])
    return {"switch_frac": f_win, "push_slack": _pick(stable)["push_slack"]}


def _sweep_delta(csr) -> Tuple[float, Dict[str, float]]:
    """Measured engine iterations per delta-scale candidate (the same on
    every device): fewer levels, fewer host round trips."""
    from ..core.algorithms.sssp import auto_delta, sssp
    base = auto_delta(csr, scaled=False)
    table = []
    for s in space.GRIDS["sssp"]["delta_scale"]:
        _, stats = sssp(csr, 0, delta=base * s, return_stats=True)
        table.append(({"delta_scale": s}, float(int(stats["iters"]))))
    table.sort(key=lambda t: t[0]["delta_scale"]
               != space.DEFAULTS["sssp.delta_scale"])
    scores = {str(cfg["delta_scale"]): cost for cfg, cost in table}
    return _pick(table)["delta_scale"], scores


def _sweep_budget(csr) -> int:
    """Packed-lane amortization: per-query cost ∝ levels(B)·ceil(B/32)/B
    (32 lanes to a word), levels(B) the largest eccentricity of 8 spread
    sources."""
    n = csr.n_rows
    sources = np.linspace(0, n - 1, 8).astype(np.int64)
    ecc = max(_eccentricities(csr, sources))
    table = []
    for b in space.GRIDS["service"]["batch_budget"]:
        words = -(-b // 32)
        table.append(({"batch_budget": b}, ecc * words * csr.nnz / b))
    table.sort(key=lambda t: t[0]["batch_budget"]
               != space.DEFAULTS["service.batch_budget"])
    return _pick(table)["batch_budget"]


# ---------------------------------------------------------------------------
# The sweep driver and the kernel measurement lane
# ---------------------------------------------------------------------------

def _card_record(device: torch.device) -> dict:
    """What a card entry names: the card, its power limit as nvidia-smi
    prints it, torch's version and the product kernel's shared memory per
    block_rows (from the built library)."""
    from ..kernels import spmv_dma
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()
        power = lines[idx] if idx < len(lines) else lines[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        power = "not read"
    lib = spmv_dma._lib()
    smem = {str(b): int(lib.bbcsr_smem_bytes(b)) for b in
            space.GRIDS["kernels.bbcsr_add"]["block_rows"]}
    return {"device": torch.cuda.get_device_name(idx),
            "power_limit": power.strip(), "torch": torch.__version__,
            "smem_bytes": smem}


def autotune(scale: int, *, device="cuda", reps: int = 5) -> dict:
    """One tuned entry for (device type, scale): sweep every grid, apply
    the gate and the hysteresis rule, record each candidate's score."""
    from ..core.graph import resolve_device
    dev = resolve_device(device)
    card = dev.type == "cuda"
    csr = probe_graph(scale, device=dev)
    level_sets = bfs_level_sets(csr)
    params: Dict[str, float] = {}
    scores: Dict[str, Dict] = {}

    for section in ("kernels.bbcsr_add", "kernels.bbcsr_min"):
        table, extra = _sweep_bbcsr(section, csr, scale, level_sets, reps)
        win = _pick(table)
        params.update({f"{section}.{k}": v for k, v in win.items()})
        scores[section] = {"unit": "us" if card else "model_bytes",
                           "candidates": table, **extra}

    eng = _sweep_engine(csr, level_sets)
    params["engine.switch_frac"] = eng["switch_frac"]
    params["engine.push_slack"] = eng["push_slack"]

    delta_scale, delta_scores = _sweep_delta(csr)
    params["sssp.delta_scale"] = delta_scale
    scores["sssp"] = {"unit": "engine_iters", "candidates": delta_scores}

    params["service.batch_budget"] = _sweep_budget(csr)

    # unswept tunables ship their defaults, so a matched entry is complete:
    # the fallback counter means "no entry", never "a hole"
    for name, val in space.DEFAULTS.items():
        params.setdefault(name, val)
    entry = {"backend": dev.type, "scale": int(scale), "params": params,
             "scores": scores}
    if card:
        entry.update(_card_record(dev))
    return entry


def _geometry(cfg: dict) -> str:
    return "{block_rows}/{block_cols}/{tile_nnz}".format(**cfg)


def format_entry(entry: dict) -> List[str]:
    """One line per BBCSR candidate of an entry (its cost, whether the gate
    admitted it and, on the card, its operand's GB), then each family's
    winner."""
    out = []
    for section in ("kernels.bbcsr_add", "kernels.bbcsr_min"):
        sc = entry["scores"][section]
        gb = {_geometry(c): g for c, g in sc.get("operand_gb", [])}
        rows = [(c, v, "admitted") for c, v in sc["candidates"]] + \
            [(c, v, "rejected") for c, v in sc.get("rejected", [])]
        for cfg, cost, verdict in rows:
            size = f", {gb[_geometry(cfg)]!r} GB" \
                if _geometry(cfg) in gb else ""
            out.append(f"{section} {_geometry(cfg)}: {cost!r} {sc['unit']}, "
                       f"{verdict}{size}")
        win = {k: entry["params"][f"{section}.{k}"]
               for k in ("block_rows", "block_cols", "tile_nnz")}
        out.append(f"{section} winner {_geometry(win)}")
    return out


def stream_peak_bytes_per_s(nbytes: int = 1 << 30, reps: int = 5,
                            device="cuda") -> float:
    """Roofline anchor: the STREAM triad ``2 * x + z`` (one fused kernel
    reading x and z and writing the result: 3 arrays an element), timed
    with CUDA events; ``nbytes`` over the three arrays, well past the
    card's L2.  A device measurement: a CPU device raises."""
    from ..core.graph import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the STREAM peak is a device measurement: pass a "
                         "CUDA device")
    n = nbytes // 4 // 3
    x = torch.arange(n, dtype=torch.float32, device=dev)
    z = torch.ones(n, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    us = _best_of_cuda(lambda: torch.add(z, x, alpha=2.0, out=out), reps)
    return 3 * n * 4 / (us * 1e-6)


def kernel_rows(scale: int, *, device="cuda", path: Optional[str] = None,
                reps: int = 5) -> List[dict]:
    """The kernel measurement lane: default vs tuned geometry per BBCSR
    family on the probe graph, and two folded rows at the reference's
    shapes (flash attention b4h8s1024 in f32, an 8k-lookup EmbeddingBag).
    On a card the port's kernels are timed (``measured: "device"``); on
    the CPU their plain versions (``"plain"``).  ``bytes_model`` is the
    reference's stream model (whole padded tiles; for 'min' summed over a
    BFS's levels): it ranks geometries, but it is not what the port's
    kernels move (they read live slots only), so ``bytes_per_s`` is no
    device rate."""
    from ..core.graph import resolve_device, to_bbcsr
    from ..kernels import ops
    dev = resolve_device(device)
    measured = "device" if dev.type == "cuda" else "plain"
    csr = probe_graph(scale, device=dev)
    level_sets = bfs_level_sets(csr)
    t = csr.transpose()
    rows = []
    for section, combine in (("kernels.bbcsr_add", "add"),
                             ("kernels.bbcsr_min", "min")):
        names = sorted(space.GRIDS[section])
        default = {k: space.DEFAULTS[f"{section}.{k}"] for k in names}
        tuned = {k: resolve(f"{section}.{k}", scale=scale, device=dev,
                            path=path) for k in names}
        x, frontier = _inputs(csr.n_rows, combine, dev)
        for label, cfg in (("default", default), ("tuned", tuned)):
            bb = to_bbcsr(t, **cfg)
            bytes_model = (bbcsr_stream_bytes(bb) if combine == "add"
                           else _spmspv_stream_bytes(bb, level_sets))
            us = _best_of(_runner(bb, combine, x, frontier), reps, dev)
            rows.append({
                "name": f"kernels/{section.split('.')[1]}/{label}",
                "config": cfg, "us": us, "bytes_model": int(bytes_model),
                "measured": measured,
                "bytes_per_s": bytes_model / (us * 1e-6)})
            del bb
    del csr, t

    q = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8, 1024, 128)).astype(np.float32)).to(dev)
    k = q[:, :4].contiguous()
    us = _best_of(lambda: ops.flash_attention(q, k, k), reps, dev)
    fa_bytes = (q.numel() + 2 * k.numel() + q.numel()) * 4
    rows.append({"name": "kernels/flash_attn_oracle_b4h8s1024", "us": us,
                 "bytes_model": int(fa_bytes), "measured": measured,
                 "bytes_per_s": fa_bytes / (us * 1e-6)})
    table = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (100_000, 16)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, 100_000, 8192).astype(np.int32)).to(dev)
    bag = torch.from_numpy(np.sort(np.random.default_rng(4).integers(
        0, 512, 8192)).astype(np.int32)).to(dev)
    us = _best_of(lambda: ops.embedding_bag(table, idx, bag, 512), reps, dev)
    eb_bytes = 8192 * 64 + 512 * 64       # gathered rows + bag outputs
    rows.append({"name": "kernels/embedding_bag_oracle_8k_lookups", "us": us,
                 "bytes_model": int(eb_bytes), "measured": measured,
                 "bytes_per_s": eb_bytes / (us * 1e-6)})
    return rows
