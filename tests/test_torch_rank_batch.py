"""Rank-local GNN batches: ``models.gnn.local_batch`` builds a rank's block
of a global batch directly (an array sliced at its rows, a
``synthetic.Rows`` built there alone) and equals, bit for bit, the block
that padding and slicing the whole global batch gives (the reference's
layout, kept here as the test's own plain version; ``place_batch`` of a
global batch is ``local_batch``'s block), for the four GNNs at smoke widths on
every rank of a dry (2, 2) mesh, at a node count the flat size divides
and one it does not, with edge and triplet counts that are no whole
number of chunks; the port's vectorized ``build_triplets`` equals the
reference's loop; ``launch.train``'s batches over a mesh are those
blocks; and a dry trace of a meshed cell counts the rank's block, not the
global batch, as its arguments."""
import argparse
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import synthetic as RSYN
from repro_torch.configs import get_config
from repro_torch.configs.common import S as spec
from repro_torch.configs.common import SpecBundle
from repro_torch.core.graph import uniform_random_graph
from repro_torch.data import synthetic as TSYN
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models import gnn as G
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gin-tu", "gatedgcn", "dimenet", "equiformer-v2"]
GRID = ((2, 2), ("data", "model"))
MAX_TRIPLETS = 700                 # 700 / 24 is no whole number of chunks


def _cfg(arch: str):
    """The smoke config, its edges and triplets streamed in chunks that
    the edge and triplet counts below do not fill."""
    cfg = get_config(arch).smoke
    return dataclasses.replace(
        cfg, edge_chunk=40 if cfg.arch == "equiformer_v2" else None,
        triplet_chunk=24 if cfg.arch == "dimenet" else None)


def _rules(rank: int):
    return make_rules(make_dry_mesh(*GRID, rank=rank))


def _sliced(cfg, batch: dict, rules) -> tuple:
    """(this rank's block, its layout) by padding and slicing the whole
    global batch: edges padded to the flat size (src and dst -1, the rest
    0), each array sliced by its logical axes, a chunked one padded to
    whole chunks (ids -1, the rest 0) and this rank's block of every chunk
    taken."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    n, E = batch["x"].shape[0], batch["src"].shape[0]
    T = batch["triplet_kj"].shape[0] if "triplet_kj" in batch else 0
    flat = rules.mesh.over(rules.flat)
    S, r = flat.size, flat.rank
    fill = lambda k: -1 if k in ("src", "dst", "triplet_kj") else 0

    def pad(v, rows, k):
        return torch.cat([v, v.new_full((rows - v.shape[0],)
                                        + tuple(v.shape[1:]), fill(k))])
    E2 = -(-E // S) * S
    for k in ("src", "dst", "wigner"):
        if k in batch:
            batch[k] = pad(batch[k], E2, k)
    axes, out = G.batch_axes(cfg), {}
    for k, v in batch.items():
        chunk = {("equiformer_v2", "src"): cfg.edge_chunk,
                 ("equiformer_v2", "dst"): cfg.edge_chunk,
                 ("equiformer_v2", "wigner"): cfg.edge_chunk,
                 ("dimenet", "triplet_kj"): cfg.triplet_chunk,
                 ("dimenet", "triplet_ji"): cfg.triplet_chunk,
                 ("dimenet", "angle"): cfg.triplet_chunk}.get((cfg.arch, k))
        if chunk is None:
            out[k] = rules.input_sharding(v.shape, *axes[k]).block(v)
            continue
        v = pad(v, -(-v.shape[0] // chunk) * chunk, k)
        per = chunk // S
        v = v.reshape((-1, chunk) + tuple(v.shape[1:]))[:, r * per:
                                                         (r + 1) * per]
        out[k] = v.reshape((-1,) + tuple(v.shape[2:]))
    return out, G._Layout(n, E2, T, S)


@pytest.mark.parametrize("n", [50, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_batch_equals_place_batch(arch, n):
    cfg = _cfg(arch)
    g = uniform_random_graph(n, 3, seed=1, device="cpu")
    whole = TSYN.gnn_batch(cfg.arch, g, cfg.d_feat, cfg.n_classes,
                           l_max=cfg.l_max, seed=2,
                           max_triplets=MAX_TRIPLETS)
    rows = TSYN.gnn_inputs(cfg.arch, g, cfg.d_feat, cfg.n_classes, seed=2)
    if cfg.arch == "dimenet":
        rows.update(TSYN.triplet_rows(rows["src"], rows["dst"], rows["pos"],
                                      MAX_TRIPLETS).entries())
    if cfg.arch == "equiformer_v2":
        rows.update(TSYN.wigner_rows(rows["src"], rows["dst"], rows["pos"],
                                     cfg.l_max).entries())
    for r in range(4):
        rules = _rules(r)
        want, lay = _sliced(cfg, whole, rules)
        placed = G.place_batch(cfg, whole, rules)
        for got in (G.local_batch(cfg, rows, rules),
                    G.local_batch(cfg, whole, rules),
                    G.RankBatch(placed[0], placed[1], r)):
            assert got.layout == lay and got.rank == r
            assert set(got.arrays) == set(want)
            for k, v in want.items():
                assert got.arrays[k].dtype == v.dtype, k
                assert torch.equal(got.arrays[k], v), (k, r)
        # a block is the step's batch as it stands, on its own rank only
        arrays, got_lay = G.place_batch(cfg, got, rules)
        assert got_lay == lay and arrays.keys() == want.keys()
        with pytest.raises(ValueError, match="block of rank"):
            G.place_batch(cfg, got, _rules((r + 1) % 4))


@pytest.mark.parametrize("seed,n,degree", [(9, 64, 4), (2, 300, 3)])
def test_triplets_equal_the_reference(seed, n, degree):
    g = uniform_random_graph(n, degree, seed=seed, device="cpu")
    src = g.row_ids().numpy().astype(np.int32)
    dst = g.indices.numpy().astype(np.int32)
    pos = np.random.default_rng(seed).standard_normal((n, 3)).astype(
        np.float32)
    for mt in (7, 4 * src.shape[0]):
        want = RSYN.build_triplets(src, dst, pos, mt)
        got = TSYN.build_triplets(src, dst, pos, mt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        rows = TSYN.triplet_rows(src, dst, pos, mt)
        assert rows.length == mt
        for lo, hi in ((0, 1), (3, 50), (mt // 3, mt), (mt, mt)):
            lo, hi = min(lo, mt), min(hi, mt)
            got = rows.build(lo, hi)
            for k, full in zip(rows.keys, want):
                assert np.array_equal(got[k], full[lo:hi])
    wig = RSYN.build_wigner(src, dst, pos, 2)
    rows = TSYN.wigner_rows(src, dst, pos, 2)
    for lo, hi in ((0, 5), (7, 40), (src.shape[0] - 3, src.shape[0])):
        assert np.array_equal(rows.build(lo, hi)["wigner"], wig[lo:hi])


@pytest.mark.parametrize("arch", ["dimenet", "equiformer-v2"])
def test_train_launcher_yields_each_ranks_block(arch):
    ac = get_config(arch)
    args = argparse.Namespace(gnn_nodes=48, seed=4)
    first = next(TT.build_batch_iter(ac, ac.smoke, args))
    for r in (0, 3):
        rules = _rules(r)
        got = next(TT.build_batch_iter(ac, ac.smoke, args, rules))
        want, lay = G.place_batch(ac.smoke, first, rules)
        assert isinstance(got, G.RankBatch) and got.layout == lay
        for k, v in want.items():
            assert torch.equal(got.arrays[k], v), (k, r)


def test_dry_trace_counts_the_ranks_block():
    """equiformer-v2 at smoke widths over a dry (2, 2) mesh: the cell's
    arguments are the state and rank 0's block of the batch, and a dry
    trace of the meshed forward on them counts those alone."""
    ac = get_config("equiformer-v2")
    cfg = dataclasses.replace(ac.smoke, edge_chunk=40)
    n, e, nc = 64, 1010, cfg.n_coef      # 1012 edges padded: 25.3 chunks
    batch = {"x": spec((n, cfg.d_feat), torch.float32),
             "src": spec((e,), torch.int32), "dst": spec((e,), torch.int32),
             "labels": spec((n,), torch.int32),
             "pos": spec((n, 3), torch.float32),
             "wigner": spec((e, nc, nc), torch.float32)}
    bundle = SpecBundle("train", cfg, batch, {})
    rules = _rules(0)
    (state, block), _ = D.cell_state(ac, bundle, rules)
    assert isinstance(block, G.RankBatch)
    assert block.arrays["wigner"].shape == (26 * 40 // 4, nc, nc)
    with torch.no_grad():
        got = D.trace(lambda st, b: G.forward(cfg, st.params, b, rules),
                      state, block)
    assert got["argument_bytes"] == D.storage_bytes((state, block))
    assert got["argument_bytes"] < D.storage_bytes((state, batch))
    assert rules.mesh.collectives > 0       # the forward ran over the mesh
