"""The streams that ``csrc/segment_mode.cu``'s split by run length creates
shapes for, as numpy arrays (no torch, no JAX): the CPU test
``tests/test_torch_segment_mode_shapes.py`` holds the plain versions to the
live reference on them, and the card tests in ``tests/test_torch_gpu.py``
hold the kernels to the plain versions on the same streams.

``tile`` is the kernels' TILE (the items a CTA takes), ``long_run`` their
LONG_RUN (a longer run streams through shared memory on its own).
"""
import numpy as np


def _weights(rng, m: int, kind: str) -> np.ndarray:
    """f32 weights spanning 1e-4 to 1e4 (so a wrong add order shows in the
    bits), with a few -inf; or small integers, which tie."""
    if kind == "ints":
        return rng.integers(0, 3, m).astype(np.float32)
    w = (rng.random(m) * 10.0 ** rng.integers(-4, 5, m)).astype(np.float32)
    w[rng.random(m) < 0.002] = -np.inf
    return w


def _ids(lengths, first: int = 0, gap: int = 1) -> np.ndarray:
    """One run of each length, with ids first, first + gap, ...: the ids
    between them have no items."""
    return np.repeat(first + gap * np.arange(len(lengths)), lengths)


def run_sum_streams(tile: int, long_run: int, seed: int = 0):
    """[(name, idx (m,) int64 sorted, w (m,) f32, n)] for ``run_sum``."""
    rng = np.random.default_rng(seed)
    t, big = long_run, long_run * 3 + 5
    # runs either side of the threshold, between short ones, so that they
    # start at every offset of a tile and cross tile boundaries
    edge = [3, t - 1, 1, t, 2, t + 1, 5, t - 1, t, t + 1, 1, 1, t + 1, 7]
    # several long runs, the last of them ending the stream
    longs = [big, 2, tile + 1, 9, big + tile // 3, 1, 4 * t + 3]
    out = []
    for name, lengths in (("threshold", edge), ("long runs", longs)):
        idx = _ids(lengths, first=1, gap=2)
        n = int(idx[-1]) + 1 if name == "long runs" else int(idx[-1]) + 4
        # ids out of range at both ends of the stream
        idx = np.concatenate([np.full(37, -2), np.full(5, -1), idx,
                              np.full(11, n), np.full(3, n + 7)])
        if name == "long runs":
            idx = idx[:len(idx) - 14]       # its last run ends the stream
        out.append((name, idx.astype(np.int64), _weights(rng, len(idx),
                                                          "f32"), n))
    # short runs only, many ids with no item
    idx = np.sort(rng.integers(-3, 9000, 40_000))
    out.append(("short runs, empty ids", idx.astype(np.int64),
                _weights(rng, len(idx), "f32"), 9000))
    out.append(("empty stream", np.zeros(0, np.int64),
                np.zeros(0, np.float32), 50))
    return out


def mode_streams(tile: int, long_run: int, seed: int = 0):
    """[(name, dst (m,) int64, label (m,) int64, w (m,) f32, n)] for the
    weighted mode, unsorted (the entry point sorts by (dst, label), keeping
    the stream's order within a run)."""
    rng = np.random.default_rng(seed + 1)
    t = long_run
    out = []
    # a hub whose label runs sit either side of the threshold, and long
    # runs of integer weights that tie (the smaller label must win)
    hub_lengths = [t - 1, t, t + 1, 3 * t + 7, 2, t + 1]
    hub_labels = [4, 9, 11, 20, 21, 30]
    dst = np.full(sum(hub_lengths), 7)
    lab = np.repeat(hub_labels, hub_lengths)
    tie = np.repeat([5, 2], [t + 1, t + 1])          # two long runs, tied
    dst = np.concatenate([dst, np.full(len(tie), 12), rng.integers(13, 40,
                                                                   3000)])
    lab = np.concatenate([lab, tie, rng.integers(0, 6, 3000)])
    tied = slice(sum(hub_lengths), sum(hub_lengths) + len(tie))
    for kind in ("f32", "ints"):
        w = _weights(rng, len(dst), kind)
        if kind == "ints":
            w[tied] = 1.0
        order = rng.permutation(len(dst))
        out.append((f"hub runs, {kind} weights", dst[order], lab[order],
                    w[order], 40))
    # ids and labels out of range at both ends (they sort after the rest)
    n = 300
    dst = np.concatenate([np.full(20, -1), rng.integers(0, n, 20_000),
                          np.full(15, n + 2), np.full(3 * t, n - 1)])
    lab = np.concatenate([rng.integers(-2, 50, 20_035),
                          np.full(3 * t, 49)])
    out.append(("out of range", dst, lab, _weights(rng, len(dst), "f32"), n))
    # a long run ends the stream
    dst = np.concatenate([rng.integers(0, n - 1, 5000), np.full(3 * t, n - 1)])
    lab = np.concatenate([rng.integers(0, 50, 5000), np.full(3 * t, 49)])
    out.append(("long last run", dst, lab, _weights(rng, len(dst), "f32"), n))
    out.append(("empty stream", np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32), 50))
    return out
