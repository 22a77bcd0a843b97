"""The port's examples (``examples/*_torch.py``) on the CPU at small sizes,
each through its ``main(argv)`` with ``--device cpu``, held to the
reference's functions on the same inputs: quickstart's BFS, PageRank and
Table I; graph_analytics' BFS, SSSP and component counts and PageRank
mass; train_lm's falling loss and its checkpoint; serve_lm's decode.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rmat as ref_rmat
from repro.core.algorithms import bfs as ref_bfs
from repro.core.algorithms import connected_components as ref_cc
from repro.core.algorithms import pagerank as ref_pagerank
from repro.core.algorithms import sssp as ref_sssp
from repro.core.algorithms import symmetrize as ref_symmetrize
from repro.core.traffic import SPMV_PROFILES, speedup

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
import graph_analytics_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_lm_torch  # noqa: E402
import train_lm_torch  # noqa: E402
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' tiny shapes run fastest on one thread beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_matches_the_reference():
    got = quickstart_torch.main(CPU)
    g = ref_rmat(10, 16, seed=0)
    lv = np.asarray(ref_bfs(g, 0))
    pr = np.asarray(ref_pagerank(g, iters=20))
    assert got["bfs_reached"] == int((lv >= 0).sum())
    assert got["bfs_depth"] == int(lv.max())
    assert abs(got["pagerank_sum"] - float(pr.sum())) <= 1e-4
    assert got["pagerank_top"] == int(pr.argmax())
    assert got["table1"] == {k: speedup(SPMV_PROFILES[k])
                             for k in quickstart_torch.PROFILES}
    assert got["spmv_diff"] <= 1e-3


def test_graph_analytics_matches_the_reference(tmp_path):
    got = graph_analytics_torch.main(CPU + ["--scale", "8", "--trace",
                                            str(tmp_path / "trace.json")])
    g = ref_rmat(8, 16, seed=7)
    lv = np.asarray(ref_bfs(g, 0, max_levels=48))
    dist = np.asarray(ref_sssp(g, 0))
    comp = np.asarray(ref_cc(ref_symmetrize(g), symmetrize_input=False))
    assert got["bfs_reached"] == int((lv >= 0).sum())
    assert got["sssp_reached"] == int(np.isfinite(dist).sum())
    assert got["components"] == len(np.unique(comp))
    assert abs(got["pagerank_mass"] - 1.0) <= 1e-3
    assert got["trace_events"] > 0 and (tmp_path / "trace.json").exists()
    assert got["service_queries"] == 112
    # the kernel route's SpMSpV: the plain gather's sum (no row over 256)
    assert got["spmspv_kernel_sum"] == pytest.approx(got["spmspv_sum"],
                                                     rel=1e-5)


def test_train_lm_loss_falls_and_checkpoints(tmp_path):
    got = train_lm_torch.main(CPU + [
        "--d-model", "64", "--layers", "2", "--vocab", "512", "--seq", "32",
        "--batch", "4", "--steps", "3", "--lr", "3e-2", "--ckpt-dir",
        str(tmp_path / "ck")])
    losses = [r["loss"] for r in got["losses"]]
    assert got["steps_run"] == 3 and len(losses) == 2
    assert losses[-1] < losses[0]
    assert got["checkpoint_step"] == 3


def test_serve_lm_decodes():
    got = serve_lm_torch.main(CPU)
    assert got["tokens"].shape == (4, 24)
    assert got["decode_s"] > 0 and got["tok_per_s"] > 0
