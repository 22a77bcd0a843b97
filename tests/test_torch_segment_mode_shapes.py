"""The plain versions of ``csrc/segment_mode.cu``'s entries, which the card
tests hold the kernels to, against the live reference on the shapes the
kernels' split by run length creates (``tests/_segment_mode_shapes.py``):
runs of LONG_RUN - 1, LONG_RUN and LONG_RUN + 1 items across tile
boundaries, several long runs (one ending the stream), ids with no items,
ids out of range at both ends, -inf weights, integer weights that tie
across long runs, and f32 weights from 1e-4 to 1e4 (so that another add
order shows in the bits).

``run_sum`` against ``jax.ops.segment_sum`` on the CPU, in f32 and (under
``jax.enable_x64``) f64; ``offload.segment_weighted_mode`` against
``repro.core.offload.segment_weighted_mode``; all bit for bit.  The split
itself is made on the card (``run_tiles``), so there is no host-side
partition to check here; the kernels' TILE and LONG_RUN are read from the
source and held to the wrapper's.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import offload as RO
from repro_torch.core import offload as TO
from repro_torch.kernels import _build
from repro_torch.kernels import segment_mode as SM

import _segment_mode_shapes as S
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

RUNS = S.run_sum_streams(SM.TILE, SM.LONG_RUN)
MODES = S.mode_streams(SM.TILE, SM.LONG_RUN)


def test_the_wrapper_states_the_kernels_split():
    src = _build.source_path("segment_mode").read_text()
    consts = {}
    for name in ("kThreads", "kTile", "kPer", "kLongRun"):
        expr = re.search(rf"constexpr int {name} = ([\w */]+);", src).group(1)
        consts[name] = eval(expr.replace("/", "//"), {}, dict(consts))
    assert consts["kTile"] == SM.TILE and consts["kLongRun"] == SM.LONG_RUN
    # the streams hold runs either side of the threshold, and longer ones
    lengths = np.concatenate([np.unique(idx, return_counts=True)[1]
                              for _, idx, _, _ in RUNS])
    for k in (SM.LONG_RUN - 1, SM.LONG_RUN, SM.LONG_RUN + 1):
        assert k in lengths
    assert (lengths > 2 * SM.LONG_RUN).sum() >= 3


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", RUNS, ids=[c[0] for c in RUNS])
def test_run_sum_plain_matches_reference(case, dtype):
    _, idx, w, n = case
    w = w.astype(np.float64) if dtype == "f64" else w
    with jax.enable_x64(dtype == "f64"):
        want = np.asarray(jax.ops.segment_sum(
            jnp.asarray(w), jnp.asarray(idx, jnp.int32), num_segments=n))
    got = TO.run_sum(torch.from_numpy(idx), torch.from_numpy(w), n).numpy()
    assert got.dtype == want.dtype == w.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", MODES, ids=[c[0] for c in MODES])
def test_segment_weighted_mode_plain_matches_reference(case):
    name, dst, lab, w, n = case
    bw, bl = RO.segment_weighted_mode(jnp.asarray(dst, jnp.int32),
                                      jnp.asarray(lab, jnp.int32),
                                      jnp.asarray(w), n)
    tw, tl = TO.segment_weighted_mode(torch.from_numpy(dst),
                                      torch.from_numpy(lab),
                                      torch.from_numpy(w), n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(bw))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(bl))
    if name.startswith("hub runs, ints"):
        # the two tied long runs: the smaller label wins
        assert tl[12] == 2 and tw[12] == SM.LONG_RUN + 1
