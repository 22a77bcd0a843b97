"""Pins where the port parts from the reference on purpose, each against
the live reference (ROADMAP §C.6, §C.7).

* §C.6: the reference's Louvain gain gate runs under ``jax.jit``, where
  XLA on the CPU fuses its multiply-adds, so a move whose exact gain is 0
  comes out at -3.6e-9 and the gate accepts it.  The port's gate takes the
  exact gain and keeps the vertex.  Both labelings have the same Q.
* §C.7: on a graph with no edges the reference raises ``IndexError`` in
  'push' and 'auto' (``_sparse_step`` gathers from an empty edge array)
  and gives the trivial answer in 'pull'.  The port gives the pull answer
  in every mode.
"""
import numpy as np
import pytest
import torch

from repro.core import algorithms as RA
from repro.core import graph as RG
from repro.core.algorithms import louvain as RL
from repro_torch.core import algorithms as TA
from repro_torch.core import graph as TG
from repro_torch.core.algorithms import louvain as TL
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

MODES = ("push", "pull", "auto")


def _both(rows, cols, vals, n):
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    return (RG.CSR.from_coo(rows, cols, vals, n, n),
            TG.CSR.from_coo(rows, cols, vals, n, n, device="cpu"))


def test_zero_gain_move_reference_takes_port_keeps():
    """n = 4: vertex 1 has a self-loop and a zero-weight edge to the
    zero-degree vertex 0.  The reference moves 1 into 0's community on a
    rounding-noise gain; the port does not.  Q is the same."""
    ref_g, port_g = _both([1, 1, 2, 3], [1, 0, 3, 2],
                          [0.8838876, 0.0, 0.7, 0.5], 4)
    r_lab, r_q = RL.louvain_local_moves(ref_g)
    t_lab, t_q = TL.louvain_local_moves(port_g)
    np.testing.assert_array_equal(np.asarray(r_lab), [0, 0, 2, 2])
    np.testing.assert_array_equal(t_lab.numpy(), [0, 1, 2, 2])
    assert float(r_q) == pytest.approx(0.48849452, abs=1e-7)
    assert float(t_q) == pytest.approx(0.48849452, abs=1e-7)


EDGELESS = {
    "bfs": (lambda A, g, m: A.bfs(g, 0, mode=m)),
    "sssp": (lambda A, g, m: A.sssp(g, 0, mode=m)),
    "msbfs": (lambda A, g, m: A.msbfs(g, np.array([0, 3], np.int32),
                                      mode=m)),
    "connected_components": (lambda A, g, m: A.connected_components(
        g, mode=m)),
    "label_propagation": (lambda A, g, m: A.label_propagation(g, mode=m)),
}


@pytest.fixture(scope="module")
def edgeless():
    return _both([], [], [], 8)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(EDGELESS))
def test_edgeless_graph_port_gives_the_pull_answer(edgeless, name, mode):
    """The port's answer in every mode is the reference's 'pull' answer,
    where the reference raises in 'push' and 'auto'."""
    ref_g, port_g = edgeless
    fn = EDGELESS[name]
    want = np.asarray(fn(RA, ref_g, "pull"))
    got = fn(TA, port_g, mode)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if mode != "pull":
        with pytest.raises(IndexError, match="empty axis"):
            fn(RA, ref_g, mode)
