"""The faults of the multi-rank pools.  Every process group of the port has
a timeout, and a collective that a peer never joins fails within it,
named (``launch.mesh``): a 2-rank gloo pool whose rank 1 skips the
collective rank 0 makes fails in seconds, not at ``spawn``'s own timeout,
with a ``CollectiveError`` that names the collective and with both ranks'
stacks.  The flat sub-mesh over every axis of a grid has a process group
of its own, apart from the world's.  And the cause of the mesh-training
pool's stalls: a rank that read the checkpoint directory after rank 0 had
begun its first save restored it, skipped the save the others made and
the barrier that waits for it, and paired every later collective with the
wrong one; every rank now takes rank 0's reading.  A SIGTERM that
reaches one rank of a training mesh makes every rank save the same step
and exit 143: the rank it reached does not save alone."""
import os
import tempfile
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as TM

import _torch_dist_cases as C
from _one_torch_thread import one_torch_thread  # noqa: F401 (autouse)

COLL_TIMEOUT = 1.0                 # seconds a collective waits for a peer


@pytest.mark.parametrize("kind", ["all_reduce", "barrier"])
def test_a_skipped_collective_fails_within_the_timeout(tmp_path, kind):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        TM.spawn(C.skip_a_collective, 2, device="cpu",
                 init_file=str(tmp_path / "init"), args=(kind, 600.0),
                 timeout=120, coll_timeout=COLL_TIMEOUT)
    took = time.monotonic() - t0
    msg = str(err.value)
    # the collective's rank fails first, named; rank 1 is still sleeping
    assert took < 60, (took, msg)
    assert "rank 0 failed" in msg and "CollectiveError" in msg, msg
    assert (f"{kind} (the mesh's all_reduce call 1, 4 B, axis 'cores' on "
            f"the world group") in msg, msg
    assert f"of a {COLL_TIMEOUT:g} s timeout" in msg, msg
    assert "did not finish" not in msg, msg
    stacks = msg.split("rank 1 stacks:")
    assert len(stacks) == 2 and "wait_in_sleep" in stacks[1], msg
    assert not list(tmp_path.iterdir())


def test_the_flat_sub_mesh_has_a_group_of_its_own():
    init = tempfile.mktemp(prefix="repro_torch_mesh1_")
    TM.init_world("gloo", init_method=f"file://{init}", world_size=1,
                  rank=0, timeout=COLL_TIMEOUT)
    try:
        mesh = TM.make_mesh((1, 1), ("data", "model"), device="cpu")
        flat = mesh.over(("data", "model"))
        assert mesh.group is None and flat.group is not None
        assert flat.group is not dist.group.WORLD
        assert {mesh.over(a).group for a in ("data", "model")}.isdisjoint(
            {None, flat.group})
        # every group has the world's timeout, read from torch
        for g in (flat.group, mesh.over("data").group,
                  mesh.over("model").group):
            assert TM.group_timeout(g).total_seconds() == COLL_TIMEOUT
        # the control and the data collectives still count together
        mesh.barrier()
        flat.all_to_all(torch.ones(2))
        assert mesh.calls == {"all_to_all": 1, "all_reduce": 1,
                              "all_gather": 0}
    finally:
        dist.destroy_process_group()
        if os.path.exists(init):
            os.unlink(init)


def test_every_rank_restores_what_rank_0_read(tmp_path):
    """Rank 1 reads the directory half a second late, after rank 0 has
    written step 0: both restore nothing, and both make the same
    collectives."""
    got = TM.spawn(C.restore_while_rank0_saves, 2, device="cpu",
                   init_file=str(tmp_path / "init"),
                   args=(str(tmp_path / "ckpt"), 0.5), timeout=60,
                   coll_timeout=COLL_TIMEOUT * 10)
    assert [g["step"] for g in got] == [None, None]
    assert got[0]["collectives"] == got[1]["collectives"]
    assert (tmp_path / "ckpt" / "step_00000000").is_dir()


def test_a_sigterm_on_one_rank_saves_on_every_rank(tmp_path):
    """Rank 1 alone gets SIGTERM after step 2: both ranks agree on it at
    the next step boundary, write step 2's checkpoint together and exit
    143 within seconds.  A handler that saved on rank 1 alone would leave
    rank 0 in step 3's all-reduce until its timeout, named."""
    t0 = time.monotonic()
    got = TM.spawn(C.sigterm_on_one_rank, 2, device="cpu",
                   init_file=str(tmp_path / "init"),
                   args=(str(tmp_path / "ckpt"), 2), timeout=60,
                   coll_timeout=COLL_TIMEOUT * 10)
    assert time.monotonic() - t0 < 30
    assert [g["code"] for g in got] == [143, 143]
    assert [g["steps"] for g in got] == [[0, 2], [0, 2]]
