"""Analytical byte-traffic / throughput model reproducing Table I & II structure
(counterpart of ``repro.core.traffic``, the same arithmetic: pure Python, so
its outputs equal the reference's exactly).

PIUMA hardware does not exist outside Intel; the paper's numbers come from a
cycle simulator plus an analytical scale-out model.  We reproduce the *model
level*: a machine is (bandwidth, DRAM latency, threads, cores, access
granularity), a workload version is (DRAM bytes, uncached loads, issued
instructions, network bytes) per nonzero/edge, and

    time/elem = max( mem bytes/BW,
                     uncached_loads * latency / threads + instrs / (cores*ipc),
                     net bytes / net_BW )

Machine parameters are the paper's disclosed specs (>16K threads/node, 256
blocks/node, power parity with a 4-socket Xeon 6140); the *emergent* ratios are
then compared against Table I (10x / 19.8x / 29.2x) and Table II by the
reference's benchmarks/table1_spmv.py and benchmarks/table2_apps.py — that
comparison is the reproduction, the constants are not fitted per-row.  The
serving layer (``core/service.py``) prices its batches with the
owner-routed exchange model below (``RouteByteCounter``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

__all__ = ["Machine", "XEON", "PIUMA_NODE", "AccessProfile", "SPMV_PROFILES",
           "APP_PROFILES", "time_per_elem", "speedup", "multinode_time_per_elem",
           "ROUTE_PAYLOAD_BYTES", "CONTRACT_PAYLOAD_BYTES",
           "push_level_route_bytes", "batched_payload_bytes",
           "flush_route_bytes", "level_collectives", "RouteByteCounter"]


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    dram_bw: float          # B/s per node
    dram_latency: float     # s
    threads: int            # latency-hiding contexts per node
    cores: int              # instruction issue pipes per node
    ipc: float              # issue rate per core
    line_bytes: int         # DRAM access granularity
    net_bw: float           # B/s per node injection bandwidth
    net_latency: float      # s, cross-node
    bw_efficiency: float    # achievable fraction of peak DRAM bw


# 4-socket Xeon Gold 6140: 4 x 6ch DDR4-2666 = 512 GB/s peak; 144 HW threads,
# 72 cores, ~4-wide issue but graph IPC ~1; 64 B lines; ~100 GbE-class fabric.
XEON = Machine("xeon-4s-6140", dram_bw=512e9, dram_latency=90e-9, threads=144,
               cores=72, ipc=1.5, line_bytes=64, net_bw=12.5e9,
               net_latency=2e-6, bw_efficiency=0.75)

# PIUMA node: 256 blocks, >16K threads ("more than 16K"), in-order MTCs,
# 8-byte native DRAM access, network BW exceeds local DRAM BW (paper §III.D).
PIUMA_NODE = Machine("piuma-node", dram_bw=2.0e12, dram_latency=100e-9,
                     threads=16384, cores=1024, ipc=1.0, line_bytes=8,
                     net_bw=2.5e12, net_latency=500e-9, bw_efficiency=0.95)


@dataclasses.dataclass(frozen=True)
class AccessProfile:
    """Per-element (nonzero or edge) costs of one implementation version."""
    name: str
    dram_bytes: float       # bytes that actually cross the DRAM pins
    uncached_loads: float   # loads the pipeline must wait on (latency-bound term)
    instrs: float           # issued instructions per element
    remote_frac: float = 0.0  # fraction of accesses that cross the network (multi-node)
    net_bytes: float = 0.0    # bytes/elem on the network when distributed


def _xeon_bytes(useful: float, sparse_accesses: float, wasted_prefetch: float = 0.2):
    """Cacheline machine: each sparse access drags a full line; prefetchers add
    ~20% dead lines (Fig. 2's zero-reuse fraction)."""
    return (useful + sparse_accesses * (XEON.line_bytes - 8)) * (1 + wasted_prefetch)


# SpMV versions of Table I.  Per nonzero: matrix value (8 B) + column index
# (4 B) stream; one sparse access into the dense vector; ~1/avg_deg row
# bookkeeping (amortized away here).
SPMV_PROFILES: Dict[str, AccessProfile] = {
    # Xeon: streams matrix (prefetched lines, fully used) + 64 B per vector access.
    "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(12.0 + 8.0, 1.0),
                          uncached_loads=0.0, instrs=10.0),
    # PIUMA base: everything uncached 8 B (3 stalled loads: val, idx, vec elem).
    "piuma_base": AccessProfile("piuma_base", dram_bytes=24.0, uncached_loads=3.0,
                                instrs=10.0),
    # cache-everything pathology: vector access now drags a 64 B line on a
    # machine sized for 8 B flows -> traffic blows up (paper: slower than base).
    "piuma_cache_all": AccessProfile("piuma_cache_all", dram_bytes=12.0 + 64.0,
                                     uncached_loads=0.0, instrs=10.0),
    # selective caching: matrix cached (streamed, full utilization), vector 8 B.
    "piuma_selective": AccessProfile("piuma_selective", dram_bytes=12.0 + 8.0,
                                     uncached_loads=1.0, instrs=10.0),
    # + DMA gather to SPAD: the engine fetches vector elements in the
    # background; the core only multiplies-accumulates out of SPAD/cache.
    "piuma_dma": AccessProfile("piuma_dma", dram_bytes=12.0 + 8.0,
                               uncached_loads=0.0, instrs=4.0),
}


# ---------------------------------------------------------------------------
# Owner-routed exchange byte model (the engine's `offload._route` traffic)
# ---------------------------------------------------------------------------

# one routed push item: int32 local index + f32 value + validity flag
ROUTE_PAYLOAD_BYTES = 4 + 4 + 1

# one routed contraction edge: coarse src + coarse dst ids + f32 summed weight
CONTRACT_PAYLOAD_BYTES = 4 + 4 + 4


def batched_payload_bytes(n_lanes: int, *, packed: bool = False) -> int:
    """Bytes of one routed item in a *batched* push level.

    A batched frontier routes one item per active edge carrying **all B
    lanes**: int32 local index + validity flag + the lane payload — 4 B per
    lane for valued programs, or ``ceil(B/32)`` uint32 words for bit-packed
    boolean frontiers.  The amortization PIUMA's concurrent traversals buy is
    visible directly here: B single-source runs route B full items per edge
    (B * ROUTE_PAYLOAD_BYTES), the batch routes one item of this size.
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    lane_bytes = 4 * (-(-n_lanes // 32)) if packed else 4 * n_lanes
    return 4 + 1 + lane_bytes


def push_level_route_bytes(n_shards: int, per_peer_capacity: int,
                           payload_bytes: int = ROUTE_PAYLOAD_BYTES) -> int:
    """Bytes one shard injects per push level through `offload._route`.

    The routed exchange is a fixed-capacity all_to_all: every level each
    shard sends `capacity` slots to each of the S peers whether or not the
    slots hold live items — so the level's network bytes are set by the
    *capacity*, not the frontier.  That is exactly why the engine's compacted
    sparse push (`engine.frontier_edge_capacity`) pays off: shrinking the
    per-peer capacity shrinks this number linearly while full-capacity
    routing pins it at m_per_shard.
    """
    return n_shards * per_peer_capacity * payload_bytes


def flush_route_bytes(n_shards: int, per_shard: int, elem_bytes: int) -> int:
    """Bytes one shard injects per async buffered flush.

    The async placement's outbox (`offload.buffered_flush`) is a dense
    ``(S * per_shard,)`` combine buffer, so one flush ships ``per_shard``
    elements to each of the S peers regardless of how many micro-steps of
    messages it absorbed — the ledger prices *flushes*, not levels.  Dense in
    the residents, so a flush costs about what a full-capacity push level
    does; the async win is doing K levels of work per flush, not shrinking
    any one exchange.
    """
    return n_shards * per_shard * elem_bytes


def level_collectives(*, placement: str, program_collectives: int = 0) -> int:
    """Collectives one engine body (level or sync step) costs the port.

    sync level, push or pull: 3 routed all_to_alls (the index, value and
    validity planes of `offload._route`; a pull level's dgas gather sends
    indices and validity and gets the values back) + the level's count
    all-reduce, plus any program-issued collectives (e.g. delta-stepping's
    two global-min reductions per level).  The count is one small int64
    vector that also carries the compacted push's overflow flag, so a
    compacted level costs no more; the reference pays a separate overflow
    psum there (its ``compact=True``).  async sync step: one buffered flush
    + the termination count — the program runs shard-local between checks,
    so program collectives don't multiply.
    """
    if placement == "async":
        return 2
    return 3 + 1 + program_collectives


@dataclasses.dataclass
class RouteByteCounter:
    """Per-level routed-byte ledger for an engine run (analytical counter).

    The engine's routing capacities are static per mode, so a run's traffic
    is reconstructed exactly from its per-level direction trace: call
    `push_level(capacity)` once per sparse level (with the level's routing
    capacity) and `pull_level(gather_bytes)` for dense levels.
    """

    n_shards: int
    payload_bytes: int = ROUTE_PAYLOAD_BYTES
    total_bytes: int = 0
    levels: int = 0

    def push_level(self, per_peer_capacity: int,
                   payload_bytes: Optional[int] = None) -> int:
        """One sparse level; ``payload_bytes`` overrides the counter's default
        per-item size (e.g. `batched_payload_bytes(B)` for a batched level)."""
        b = push_level_route_bytes(
            self.n_shards, per_peer_capacity,
            self.payload_bytes if payload_bytes is None else payload_bytes)
        self.total_bytes += b
        self.levels += 1
        return b

    def pull_level(self, gather_bytes: int) -> int:
        self.total_bytes += int(gather_bytes)
        self.levels += 1
        return int(gather_bytes)

    def flush_level(self, per_shard: int, elem_bytes: int = 4) -> int:
        """One async buffered flush (`offload.buffered_flush`): the dense
        per-resident outbox changes hands, priced by `flush_route_bytes`."""
        b = flush_route_bytes(self.n_shards, per_shard, elem_bytes)
        self.total_bytes += b
        self.levels += 1
        return b

    def contract_level(self, n_routed_edges: int,
                       payload_bytes: int = CONTRACT_PAYLOAD_BYTES) -> int:
        """One multi-level contraction: `n_routed_edges` locally pre-reduced
        coarse edges change owner shard (unlike the fixed-capacity push
        exchange, contraction ships exactly the surviving edges — the
        between-levels repartition is host-driven, not a static all_to_all).

        Streaming ingest (DESIGN.md §16) prices through the same call: an
        `apply_updates` batch reships the touched partitions' edge lists
        (every partition on compaction) as (src, dst, weight) contract
        payloads — same item shape, same host-driven repartition."""
        b = int(n_routed_edges) * payload_bytes
        self.total_bytes += b
        self.levels += 1
        return b


def time_per_elem(m: Machine, p: AccessProfile) -> float:
    mem = p.dram_bytes / (m.dram_bw * m.bw_efficiency)
    lat = p.uncached_loads * m.dram_latency / m.threads + p.instrs / (m.cores * m.ipc * 1e9)
    return max(mem, lat)


def speedup(p_piuma: AccessProfile, p_xeon: AccessProfile = SPMV_PROFILES["xeon"],
            piuma: Machine = PIUMA_NODE, xeon: Machine = XEON) -> float:
    return time_per_elem(xeon, p_xeon) / time_per_elem(piuma, p_piuma)


def multinode_time_per_elem(m: Machine, p: AccessProfile, n_nodes: int) -> float:
    """Scale-out model: local work shrinks 1/n, remote accesses ride the network.

    Remote fraction grows as (n-1)/n of the uniformly-distributed accesses
    (DGAS interleave); network term includes per-node injection bandwidth and
    a latency term hidden by the thread pool.
    """
    if n_nodes == 1:
        return time_per_elem(m, p)
    rf = p.remote_frac * (n_nodes - 1) / n_nodes
    mem = p.dram_bytes / (m.dram_bw * m.bw_efficiency)
    net = (p.net_bytes * rf) / m.net_bw
    lat = (p.uncached_loads * ((1 - rf) * m.dram_latency + rf * m.net_latency) / m.threads
           + p.instrs / (m.cores * m.ipc * 1e9))
    return max(mem, net, lat) / n_nodes


# Table II applications: per-edge access profiles (PIUMA implementation) and a
# Xeon counterpart.  Derived from each algorithm's inner loop; see
# benchmarks/table2_apps.py for the comparison against the paper's column.
APP_PROFILES: Dict[str, Dict[str, AccessProfile]] = {
    "SpMV": {
        "piuma": dataclasses.replace(SPMV_PROFILES["piuma_dma"], remote_frac=1.0, net_bytes=16.0),
        "xeon": SPMV_PROFILES["xeon"],
    },
    "SpMSpV": {
        # sparse x sparse: tiny useful stream per touched edge; Xeon still drags lines
        "piuma": AccessProfile("piuma", dram_bytes=20.0, uncached_loads=0.0, instrs=6.0,
                               remote_frac=1.0, net_bytes=16.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(12.0, 2.0), uncached_loads=0.0,
                              instrs=25.0),
    },
    "Breadth-first Search": {
        "piuma": AccessProfile("piuma", dram_bytes=20.0, uncached_loads=1.0, instrs=8.0,
                               remote_frac=1.0, net_bytes=16.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(12.0, 1.0), uncached_loads=0.0,
                              instrs=12.0),
    },
    "Random Walks": {
        # pure pointer chasing: two dependent uncached loads per step, ~zero locality
        "piuma": AccessProfile("piuma", dram_bytes=16.0, uncached_loads=2.0, instrs=6.0,
                               remote_frac=1.0, net_bytes=16.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(8.0, 2.0), uncached_loads=2.0,
                              instrs=8.0),
    },
    "PageRank": {
        "piuma": AccessProfile("piuma", dram_bytes=20.0, uncached_loads=0.0, instrs=5.0,
                               remote_frac=1.0, net_bytes=16.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(20.0, 1.0), uncached_loads=0.0,
                              instrs=10.0),
    },
    "Louvain Community": {
        "piuma": AccessProfile("piuma", dram_bytes=24.0, uncached_loads=1.0, instrs=12.0,
                               remote_frac=1.0, net_bytes=24.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(16.0, 2.0), uncached_loads=0.0,
                              instrs=30.0),
    },
    "TIES Sampler": {
        "piuma": AccessProfile("piuma", dram_bytes=16.0, uncached_loads=1.0, instrs=8.0,
                               remote_frac=1.0, net_bytes=16.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(8.0, 2.0), uncached_loads=1.0,
                              instrs=12.0),
    },
    "Graph Sage": {
        # dense per-vertex GEMMs dominate -> smallest PIUMA edge (paper: 3.1x)
        "piuma": AccessProfile("piuma", dram_bytes=80.0, uncached_loads=0.5, instrs=120.0,
                               remote_frac=0.3, net_bytes=32.0),
        "xeon": AccessProfile("xeon", dram_bytes=_xeon_bytes(80.0, 0.5), uncached_loads=0.0,
                              instrs=150.0),
    },
}
