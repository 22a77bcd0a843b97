"""Port parity for the DGAS layer, in process: ``repro_torch``'s ATT rules,
the host-side sharding (``shard_graph``, ``reverse_graph``,
``shard_vertex_array`` / ``unshard_vertex_array``), the owner-slot
assignment, and the routed ``offload`` primitives on a 1-rank gloo world
against the reference's on a 1-device mesh (as ``tests/test_offload.py``
runs them: the collectives degenerate, the slot bookkeeping, masking and
combines do not), on the same numpy inputs.  Also the mesh's backend rule
and the device rule.  Multi-rank runs are ``tests/test_torch_distributed.py``.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.core import dgas as RD
from repro.core import engine as RE
from repro.core import graph as RG
from repro.core import offload as RO
from repro.core.algorithms import distgraph as RDG
from repro_torch.core import dgas as TD
from repro_torch.core import engine as TE
from repro_torch.core import offload as TO
from repro_torch.core.algorithms import distgraph as TDG
from repro_torch.core.graph import csr_from_numpy
from repro_torch.launch import mesh as TM
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

MESH = jax.make_mesh((1,), ("x",))
SPEC = P("x")
N = 37


def _rules(n, S, indptr):
    """Each rule as (reference ATT, port ATT)."""
    b = np.array([0, 5, 5, 20, n][:S] + [n], np.int32)
    b = np.maximum.accumulate(np.minimum(b, n))
    return {
        "interleave": (RD.interleave_rule(n, S), TD.interleave_rule(n, S)),
        "block": (RD.block_rule(n, S), TD.block_rule(n, S)),
        "boundaries": (RD.custom_boundary_rule(b, n),
                       TD.custom_boundary_rule(b, n)),
        "degree_balanced": (RD.degree_balanced_rule(indptr, S),
                            TD.degree_balanced_rule(indptr, S)),
    }


def _graph():
    return RG.rmat(6, 8, seed=2)


def _port(g):
    return csr_from_numpy(np.asarray(g.indptr), np.asarray(g.indices),
                          None if g.values is None else np.asarray(g.values),
                          g.n_rows, g.n_cols, device="cpu")


@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("kind", ["interleave", "block", "boundaries",
                                  "degree_balanced"])
def test_att_rules_match_reference(kind, S):
    g = _graph()
    n = g.n_rows
    r, t = _rules(n, S, np.asarray(g.indptr))[kind]
    assert t.per_shard == r.per_shard and t.n_shards == r.n_shards
    # every id, the shard edges among them, and out-of-range ids
    gid = np.arange(-2, n + 2, dtype=np.int32)
    tg = torch.from_numpy(gid)
    for fn in ("owner", "local", "flat_slot"):
        want = np.asarray(getattr(r, fn)(jnp.asarray(gid)))
        got = getattr(t, fn)(tg).numpy()
        in_range = (gid >= 0) & (gid < n)
        np.testing.assert_array_equal(got[in_range], want[in_range], fn)
    owner = np.array(r.owner(jnp.asarray(gid[2:-2])))
    local = np.array(r.local(jnp.asarray(gid[2:-2])))
    np.testing.assert_array_equal(
        t.to_global(torch.from_numpy(owner), torch.from_numpy(local)).numpy(),
        np.asarray(r.to_global(jnp.asarray(owner), jnp.asarray(local))))
    for s in range(S):
        if kind == "interleave":
            with pytest.raises(ValueError):
                t.shard_slice(s)
        else:
            assert t.shard_slice(s) == r.shard_slice(s)
        gid_s, real = t.resident(s, "cpu")
        np.testing.assert_array_equal(
            gid_s[real].numpy(), gid[2:-2][owner == s])


def test_out_of_range_ids_translate_like_reference():
    """Ids outside [0, n) decide which owner's bucket a gather request
    takes, so their owner must be the reference's too."""
    for kind in ("interleave", "block", "boundaries"):
        r, t = _rules(N, 4, np.arange(N + 1))[kind]
        gid = np.array([-3, -1, N, N + 5], np.int32)
        np.testing.assert_array_equal(
            t.owner(torch.from_numpy(gid)).numpy(),
            np.asarray(r.owner(jnp.asarray(gid))))


@pytest.mark.parametrize("S", [2, 4])
def test_shard_graph_and_vertex_arrays_match_reference(S):
    g = _graph()
    tg = _port(g)
    for rule in (None, "block"):
        r_att = None if rule is None else RD.block_rule(g.n_rows, S)
        t_att = None if rule is None else TD.block_rule(g.n_rows, S)
        rg, r_att = RDG.shard_graph(g, S, row_att=r_att)
        tgs, t_att = TDG.shard_graph(tg, S, row_att=t_att)
        for f in ("src", "dst", "val"):
            np.testing.assert_array_equal(getattr(tgs, f).numpy(),
                                          np.asarray(getattr(rg, f)))
        assert tgs.edges_per_shard == rg.edges_per_shard
        x = np.random.default_rng(S).random((g.n_rows, 3)).astype(np.float32)
        xs = TDG.shard_vertex_array(x, t_att)
        np.testing.assert_array_equal(
            xs.numpy(), np.asarray(RDG.shard_vertex_array(x, r_att)))
        np.testing.assert_array_equal(
            TDG.unshard_vertex_array(xs, t_att).numpy(), x)
        shard = tgs.shard(S - 1, "cpu")
        np.testing.assert_array_equal(shard.src.numpy(),
                                      np.asarray(rg.src)[S - 1])
    att_r, att_t = RD.block_rule(g.n_rows, S), TD.block_rule(g.n_rows, S)
    rr, tr = RE.reverse_graph(g, att_r), TE.reverse_graph(tg, att_t)
    for f in ("src", "dst", "val"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(rr, f)))


@pytest.mark.parametrize("capacity", [0, 1, 3, 40])
def test_owner_slots_match_reference(capacity):
    rng = np.random.default_rng(capacity)
    dest = rng.integers(-1, 6, 40).astype(np.int32)   # -1 and 5: invalid
    flat, valid = RO._owner_slots(jnp.asarray(dest), 5, capacity)
    tflat, tvalid = TO._owner_slots(torch.from_numpy(dest), 5, capacity)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(flat))


@pytest.fixture(scope="module")
def mesh1():
    """A 1-rank gloo world on the CPU in this process."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    init = tempfile.mktemp(prefix="repro_torch_dgas_")
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    try:
        yield TM.make_cores_mesh("cpu")
    finally:
        dist.destroy_process_group()


def _ref(fn, *xs, n_out=1):
    out = jax.jit(shard_map(fn, mesh=MESH, in_specs=(SPEC,) * len(xs),
                            out_specs=(SPEC,) * n_out if n_out > 1
                            else SPEC))(*[jnp.asarray(x)[None] for x in xs])
    return [np.asarray(o)[0] for o in out] if n_out > 1 else \
        np.asarray(out)[0]


@pytest.mark.parametrize("kind,capacity", [("interleave", None),
                                           ("block", 4), ("boundaries", 30)])
def test_routed_primitives_match_reference(mesh1, kind, capacity):
    """Each routed primitive on the same inputs (ids out of range among
    them; capacity 4 drops items); the reference's side is one mapped call
    (a shard_map compile costs seconds)."""
    rng = np.random.default_rng(7)
    r_att, t_att = _rules(N, 1, np.arange(N + 1))[kind]
    per = t_att.per_shard
    table = rng.standard_normal(per).astype(np.float32)
    gidx = rng.integers(-2, N + 2, 30).astype(np.int32)
    vals = rng.standard_normal(30).astype(np.float32)
    lanes = rng.standard_normal((30, 3)).astype(np.float32)
    labels = rng.integers(-1, 5, 30).astype(np.int32)
    words = rng.integers(-2**31, 2**31, (30, 2), dtype=np.int64).astype(
        np.int32)
    weights = np.abs(vals)
    kw = dict(capacity=capacity)
    lanes0 = np.tile(table[:, None], 3)

    def ref(tb, g, v, ln, lab, w, wd):
        tb, g, v, ln, lab, w, wd = (a[0] for a in (tb, g, v, ln, lab, w, wd))
        tl = jnp.tile(tb[:, None], 3)
        out = (RO.dgas_gather(tb, g, r_att, "x", fill=-5.0, **kw),
               RO.remote_scatter_add(tb, g, v, r_att, "x", **kw),
               RO.remote_scatter_combine(tl, g, ln, r_att, "x",
                                         combine="min", identity=np.inf,
                                         **kw),
               RO.remote_scatter_combine(tl, g, ln, r_att, "x",
                                         combine="max", identity=-np.inf,
                                         **kw),
               RO.remote_scatter_or(per, g, wd, r_att, "x", **kw),
               *RO.remote_scatter_weighted_mode(per, g, lab, w, r_att, "x",
                                                **kw),
               RO.all_gather_gather(tb, g, r_att, "x", fill=2.0))
        return tuple(o[None] for o in out)

    want = _ref(ref, table, gidx, vals, lanes, labels, weights,
                words.view(np.uint32), n_out=8)
    T = torch.from_numpy
    got = (TO.dgas_gather(T(table), T(gidx), t_att, mesh1, fill=-5.0, **kw),
           TO.remote_scatter_add(T(table.copy()), T(gidx), T(vals), t_att,
                                 mesh1, **kw),
           TO.remote_scatter_combine(T(lanes0.copy()), T(gidx), T(lanes),
                                     t_att, mesh1, combine="min",
                                     identity=np.inf, **kw),
           TO.remote_scatter_combine(T(lanes0.copy()), T(gidx), T(lanes),
                                     t_att, mesh1, combine="max",
                                     identity=-np.inf, **kw),
           TO.remote_scatter_or(per, T(gidx), T(words), t_att, mesh1, **kw),
           *TO.remote_scatter_weighted_mode(per, T(gidx), T(labels),
                                            T(weights), t_att, mesh1, **kw),
           TO.all_gather_gather(T(table), T(gidx), t_att, mesh1, fill=2.0))
    names = ("dgas_gather", "scatter_add", "combine_min", "combine_max",
             "scatter_or", "mode_w", "mode_label", "all_gather_gather")
    for name, g_, w_ in zip(names, got, want):
        g_ = g_.numpy()
        if name == "scatter_or":
            w_ = w_.view(np.int32)
        if name == "scatter_add":
            np.testing.assert_allclose(g_, w_, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g_, w_, err_msg=name)


def test_buffered_flush_and_scans_match_reference(mesh1):
    rng = np.random.default_rng(3)
    box = rng.integers(-50, 50, (12, 2)).astype(np.int32)
    x = np.array([3, 4], np.int32)
    combines = ("add", "min", "max", "or")

    def ref(b, bu, v):
        out = [RO.buffered_flush(bu[0] if c == "or" else b[0], "x",
                                 combine=c) for c in combines]
        return tuple(o[None] for o in out + [RO.prefix_scan(v[0], "x")])

    want = _ref(ref, box, box.view(np.uint32), x, n_out=5)
    for c, w_ in zip(combines, want):
        got = TO.buffered_flush(torch.from_numpy(box), mesh1, combine=c)
        np.testing.assert_array_equal(
            got.numpy(), w_.view(np.int32) if c == "or" else w_, err_msg=c)
    got = TO.prefix_scan(torch.from_numpy(x), mesh1)
    np.testing.assert_array_equal(got.numpy(), want[-1])
    assert int(TO.barrier(mesh1)) == 1
    assert float(TO.hierarchical_psum(torch.tensor(2.5), [mesh1])) == 2.5


def test_mesh_counts_collectives_and_bytes(mesh1):
    mesh1.reset_counts()
    TO.dgas_gather(torch.zeros(4), torch.arange(4, dtype=torch.int32),
                   TD.block_rule(4, 1), mesh1, capacity=4)
    # the index plane (4 x 4 B), the validity plane (4 x 1 B), the reply
    assert mesh1.calls["all_to_all"] == 3
    assert mesh1.bytes["all_to_all"] == 16 + 4 + 16
    TO.global_min(torch.zeros(3), mesh1)
    assert mesh1.counts()["collectives"] == 4
    assert mesh1.bytes["all_reduce"] == 12
    # capacity 0 routes nothing: every request reads the fill (the
    # reference's take raises on the empty reply instead)
    got = TO.dgas_gather(torch.ones(4), torch.arange(4, dtype=torch.int32),
                         TD.block_rule(4, 1), mesh1, capacity=0, fill=-1.0)
    assert got.tolist() == [-1.0] * 4


def test_all_reduce_is_one_collective_under_vmap(mesh1):
    mesh1.reset_counts()
    x = torch.rand(5, 7)
    got = torch.func.vmap(lambda r: TO.global_min(r.min(), mesh1))(x)
    np.testing.assert_array_equal(got.numpy(), x.min(1).values.numpy())
    assert mesh1.calls["all_reduce"] == 1 and mesh1.bytes["all_reduce"] == 20


@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda", 4, 1, "gloo"),
    ("cuda", 4, 2, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 1, 1, "nccl")])
def test_backend_rule(device, ranks, cards, want):
    assert TM.backend_for(device, ranks, n_cards=cards) == want
    if device == "cuda":
        assert TM.rank_device(device, ranks - 1, n_cards=cards) == \
            torch.device("cuda", (ranks - 1) % cards)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.backend_for("cuda", 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.spawn(print, 2, init_file=tempfile.mktemp())


def test_queue_balance_on_one_rank_matches_reference(mesh1):
    """``queue_balance`` with a payload on the 1-rank world equals the
    reference's on the 1-device mesh: the items compacted to a prefix,
    the payload riding along (-0.0 routed as +0.0), rows without an item
    zeroed.  Four ranks: ``tests/test_torch_dist_more.py``."""
    rng = np.random.default_rng(5)
    items = np.full(12, -1, np.int32)
    items[:7] = rng.integers(0, 99, 7)
    pay = rng.standard_normal((12, 3)).astype(np.float32)
    pay[2, 1] = -0.0

    def ref(it, pl):
        q, p = RO.queue_balance(RO.QueueState(it[0], jnp.int32(7)), "x",
                                pl[0])
        return q.items[None], q.count[None], p[None]

    want = _ref(ref, items, pay, n_out=3)
    q, p = TO.queue_balance(TO.QueueState(torch.from_numpy(items),
                                          torch.tensor(7, dtype=torch.int32)),
                            mesh1, {"cur": torch.from_numpy(pay)})
    np.testing.assert_array_equal(q.items.numpy(), want[0])
    np.testing.assert_array_equal(q.count.numpy(), want[1])
    assert p["cur"].numpy().tobytes() == want[2].tobytes()


def test_mesh_axes_and_run_queue_on_one_rank(mesh1):
    """``Mesh.over``: None and the mesh's own axis name are the mesh, an
    unknown axis raises; ``hierarchical_psum`` by axis names;
    ``run_queue`` stacks each iteration's outputs and keeps a step's
    retirements out of the next balance."""
    assert mesh1.over() is mesh1 and mesh1.over("cores") is mesh1
    assert mesh1.over(("cores",)) is mesh1
    with pytest.raises(ValueError, match="no sub-mesh"):
        mesh1.over("model")
    x = torch.tensor([1.5, -2.0])
    assert TO.hierarchical_psum(x, ("cores",), mesh1).tolist() == [1.5, -2.0]

    def step(ops, items, cur, state, it, key):
        # retire every item of an odd value, move the rest one vertex on
        items = torch.where(items % 2 == 1, -1, items)
        return items, cur + 1, state + (items >= 0).sum(), (items, cur)

    items0 = torch.tensor([3, 4, 7, 8, -1, -1], dtype=torch.int32)
    state, (ids, cur) = TE.run_queue(mesh1, TE.QueueProgram(step), items0,
                                     torch.arange(6, dtype=torch.int32), (),
                                     n_iters=3, state0=0)
    assert state.tolist() == 6 and ids.shape == (3, 6)
    assert cur.shape == (3, 6)
    assert ids[0].tolist() == [-1, 4, -1, 8, -1, -1]
    assert ids[1].tolist() == [4, 8, -1, -1, -1, -1]
    assert cur[1, :2].tolist() == [2, 4]
