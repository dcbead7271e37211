"""The benchmark's ``train_resident`` traffic kind (``c3md.train``) on the
CPU at a tiny size: the dispatches it keeps record the batches the
program's device draw named, and its check passes the program as it is
and fails each planted fault under the cell's own limits."""

import gc
import time
import weakref

import pytest
import torch

from portbench import harness, weights
from portbench.reference import dmv3d

SEED = 2**31 + 41



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tiny models: the suite runs
    several worker processes on a few cores, and torch's default of a
    thread per core each makes them wait on one another's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _tiny():
    """``c3md.train`` at tiny widths in float32 and the exact warp, 16²,
    a bank of 4 scenes, B 2 of 3 orbit frames: still 16 optimizer steps a
    dispatch, c3md's remat, multidepth and cosine warm-up."""
    cell = harness.load_cell("c3md.train")
    c = cell["config_file"]["config"]
    c["model"].update(image_size=16, base_features=4, max_features=8,
                      num_levels=2, gru_features=8, pose_embed_dim=8,
                      src_head_features=4, dtype="float32",
                      warp_precision="exact")
    c["data"].update(image_size=16, num_scenes=4)
    cell["traffic_file"].update(batch=2, seq_len=3)
    assert c["train"]["steps_per_dispatch"] == 16
    return cell


def test_kept_dispatch_records_the_rows_the_draw_named():
    from dynamic_multiview_3d_torch.utils import jax_random
    cell = _tiny()
    m = cell["config_file"]["config"]["model"]
    params = weights.draw(dmv3d.param_shapes(m), SEED, "cpu")
    work = harness.kind(cell).Work(cell, SEED, torch.device("cpu"), params)
    bank = work.bank
    meta = bank.sample_meta()
    kept = work.first["batches"]
    assert len(kept) == 16 and work.state.step == 16
    for step, batch in enumerate(kept):
        key = jax_random.step_keys(SEED % 2**32, step, True)[1]
        idx = bank.device_draw(meta, key, 2, "cpu")
        for name, table, rows in (
                ("image_seq", bank.frames, "seq_idx"),
                ("tgt_images", bank.frames, "tgt_idx"),
                ("src_poses", bank.poses, "src_pose_idx"),
                ("tgt_poses", bank.poses, "tgt_pose_idx")):
            want = table[idx[rows].reshape(-1)].reshape(batch[name].shape)
            assert torch.equal(batch[name], want), (step, name)
    # the window starts from the state set-up's dispatch left, kept apart
    assert work.start["count"] == 16
    work.free()


def test_free_releases_the_bank_without_the_cyclic_collector():
    """The kept dispatch's patch of ``device_sample`` leaves no reference
    cycle: freed, the bank goes at once, not whenever Python's cyclic
    collector runs (a run after it in the same process would count it in
    its ``peak_mem_gib``)."""
    cell = _tiny()
    m = cell["config_file"]["config"]["model"]
    params = weights.draw(dmv3d.param_shapes(m), SEED, "cpu")
    work = harness.kind(cell).Work(cell, SEED, torch.device("cpu"), params)
    work.window(0.0)
    bank = weakref.ref(work.bank)
    gc.disable()
    try:
        work.free()
        assert bank() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "double.window"])
def test_check_passes_the_program_and_fails_each_fault(fault):
    cell = _tiny()
    planted = harness.kind(cell).FAULTS[fault]() if fault else None
    if planted:
        planted.__enter__()
    try:
        out = harness.run_cell(cell, SEED, 0.0, False, "cpu",
                               time.perf_counter())
    finally:
        if planted:
            planted.__exit__(None, None, None)
    assert out["correct"] == (fault is None), out["checks"]
