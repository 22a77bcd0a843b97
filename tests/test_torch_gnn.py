"""Port parity for ``repro_torch.models.gnn`` against ``repro.models.gnn``:
the four architectures (gin, gatedgcn, dimenet, equiformer_v2) at smoke
widths on the same numpy batch (``repro.data.synthetic.gnn_batch``) and
carried parameters (``gnn.params_from_reference`` unstacks the
reference's stacked layers): the forward's outputs, the loss and the
gradient of every parameter within 1e-4, DimeNet's triplets and
EquiformerV2's edges streamed in chunks that do not divide them.  The
reference side is computed once per module.

Gradients are held per parameter to rtol 1e-4 and atol 1e-5 of the
model's largest gradient: a few are zero in exact arithmetic (the last
bias of EquiformerV2's attention MLP shifts every logit of a softmax) and
read as rounding noise, 1e-10, on both sides.

Also: the B4 autograd Functions (``gnn.segment_sum``, ``gnn.gather_rows``)
against ``jax.ops.segment_sum`` and ``offload.dma_gather`` and their VJPs,
with ids unsorted and out of range; the initialisers' shapes and moments;
the meshed DGAS branch on a 1-rank mesh against the local one
(``tests/test_torch_mesh_train.py`` holds it on 4 ranks)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.core import offload as ROFF
from repro.core.graph import uniform_random_graph
from repro.data import synthetic as RSYN
from repro.models import gnn as RGNN
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.models import gnn as G
from repro_torch.optim import adamw

ARCHS = ["gin-tu", "gatedgcn", "dimenet", "equiformer-v2"]
# chunks that leave a ragged last chunk: the padded tails must drop out
CHUNKS = {"dimenet": dict(triplet_chunk=70),
          "equiformer-v2": dict(edge_chunk=50)}
RTOL, GRAD_ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def gnn_case(request):
    arch = request.param
    rcfg = dataclasses.replace(ref_config(arch).smoke,
                               **CHUNKS.get(arch, {}))
    cfg = dataclasses.replace(get_config(arch).smoke, **CHUNKS.get(arch, {}))
    g = uniform_random_graph(48, 3, seed=1)
    batch = RSYN.gnn_batch(rcfg.arch, g, rcfg.d_feat, rcfg.n_classes,
                           l_max=rcfg.l_max)
    rp = RGNN.init_params(rcfg, jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        loss, m = RGNN.loss_fn(rcfg, p, jb)
        return loss, (m, RGNN.forward(rcfg, p, jb))
    (loss, (metrics, out)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(rp)
    ref = dict(loss=float(loss), acc=float(metrics["acc"]), out=_np(out),
               grads=_np(grads))
    return arch, cfg, _np(rp), batch, ref


def test_forward_loss_and_gradients_match_reference(gnn_case):
    arch, cfg, rp, batch, ref = gnn_case
    params = G.params_from_reference(cfg, rp, device="cpu")
    state = adamw.init_state(params)          # parameters now require grad
    loss, metrics = G.loss_fn(cfg, state.params, batch)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref["loss"], rel=RTOL)
    assert float(metrics["acc"]) == pytest.approx(ref["acc"], abs=1e-6)
    with torch.no_grad():
        out = G.forward(cfg, params, batch)
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=RTOL,
                               atol=RTOL * np.abs(ref["out"]).max())
    want = adamw.named_params(G.params_from_reference(cfg, ref["grads"],
                                                      device="cpu"))
    got = adamw.named_params(params)
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        assert got[k].grad is not None, k
        np.testing.assert_allclose(got[k].grad.numpy(), w.numpy(), rtol=RTOL,
                                   atol=GRAD_ATOL * scale,
                                   err_msg=f"{arch} {k}")


def test_params_from_reference_unstacks_and_init_matches_shapes(gnn_case):
    arch, cfg, rp, _, _ = gnn_case
    carried = adamw.named_params(G.params_from_reference(cfg, rp,
                                                         device="cpu"))
    drawn = adamw.named_params(G.init_params(cfg, 3, device="cpu"))
    meta = adamw.named_params(G.init_params(cfg, device="meta"))
    assert set(carried) == set(drawn) == set(meta)
    n_stacked = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(rp))
    assert sum(p.numel() for p in carried.values()) == n_stacked
    for k, p in carried.items():
        assert drawn[k].shape == p.shape == meta[k].shape, k
        assert drawn[k].dtype == torch.float32
    # dense leaves draw N(0, 1 / fan_in) as the reference's do
    for k, p in drawn.items():
        if p.dim() == 2 and p.numel() >= 1024:
            assert float(p.std()) == pytest.approx(p.shape[0] ** -0.5,
                                                   rel=0.1), k


def test_segment_sum_function_matches_jax_and_its_vjp():
    rng = np.random.default_rng(0)
    n = 9
    seg = rng.integers(-2, n + 2, 200).astype(np.int32)   # unsorted, padding
    data = rng.standard_normal((200, 3, 4)).astype(np.float32)
    cot = rng.standard_normal((n, 3, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda d: jax.ops.segment_sum(
        d, jnp.asarray(np.where((seg >= 0) & (seg < n), seg, n)),
        num_segments=n), jnp.asarray(data))
    td = torch.from_numpy(data).requires_grad_(True)
    got = G.segment_sum(td, torch.from_numpy(seg), n)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-6)
    assert not bool(td.grad[(seg < 0) | (seg >= n)].any())


def test_gather_rows_function_matches_dma_gather_and_its_vjp():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((7, 5)).astype(np.float32)
    idx = rng.integers(-1, 9, 40).astype(np.int32)
    cot = rng.standard_normal((40, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: ROFF.dma_gather(t, jnp.asarray(idx)),
                        jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = G.gather_rows(tt, torch.from_numpy(idx))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), rtol=1e-6, atol=1e-6)
    one_d = G.gather_rows(torch.arange(4.0), torch.tensor([3, -1, 0]))
    assert one_d.tolist() == [3.0, 0.0, 0.0]


def test_edge_head_softmax_matches_reference():
    """EquiformerV2's per-destination softmax over heads, padded edges
    (valid False) included, and its gradient through B4's Function."""
    rng = np.random.default_rng(2)
    n, e, heads = 6, 50, 3
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.random(e) < 0.8
    alpha = rng.standard_normal((e, heads)).astype(np.float32)
    cot = rng.standard_normal((e, heads)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: RGNN._edge_head_softmax(
        a, jnp.asarray(valid), jnp.asarray(dst), n, heads), jnp.asarray(alpha))
    a = torch.from_numpy(alpha).requires_grad_(True)
    got = G._edge_head_softmax(a, torch.from_numpy(valid),
                               torch.from_numpy(dst), n, heads)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(vjp(
        jnp.asarray(cot))[0]), rtol=1e-5, atol=1e-6)


def test_mesh_gather_and_scatter_raise():
    """The name is kept from when the meshed branch raised.  Over a 1-rank
    (1, 1) mesh with DGAS forced, ``gather_nodes`` and
    ``scatter_add_nodes`` route through the mesh and equal the local ones,
    forward and backward; over a mesh a table's global rows must be
    given."""
    import _torch_mesh_cases as MC
    cfg = dataclasses.replace(get_config("gin-tu").smoke, dgas_threshold=1)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((6, 3)).astype(np.float32)
    vals0 = rng.standard_normal((5, 3)).astype(np.float32)
    idx = torch.tensor([0, 5, -1, 2, 2])
    cot = torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32))
    cot_n = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))

    def run(rules, **kw):
        x = torch.from_numpy(x0).requires_grad_(True)
        vals = torch.from_numpy(vals0).requires_grad_(True)
        g = G.gather_nodes(cfg, x, idx, rules, **kw)
        s = G.scatter_add_nodes(cfg, 6, idx, vals, rules, **kw)
        ((g * cot).sum() + (s * cot_n).sum()).backward()
        return [t.detach().numpy() for t in (g, s, x.grad, vals.grad)]

    want = run(make_rules(None))
    with MC.one_rank_mesh() as mesh:
        got = run(make_rules(mesh), n=6)
        assert mesh.calls["all_to_all"] > 0
        with pytest.raises(ValueError, match="n="):
            G.gather_nodes(cfg, torch.from_numpy(x0), idx, make_rules(mesh))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
