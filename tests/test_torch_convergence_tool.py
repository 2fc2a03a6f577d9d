"""The resume path of tools/convergence_torch.py on the CPU, at a tiny
size: a run stopped in the middle and resumed from its last checkpoint
ends bitwise where one uninterrupted run ends, and a run stopped while a
checkpoint is being written resumes from the one before."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convergence_torch as conv  # noqa: E402

from d2dgs_torch.config import RasterConfig  # noqa: E402
from d2dgs_torch.io import checkpoint  # noqa: E402
from d2dgs_torch.train.config import TrainConfig  # noqa: E402

# One intra-op thread: the test suite runs its files in parallel worker
# processes, whose OpenMP threads would contend with one another.
torch.set_num_threads(1)

# the tool's two stages at a tiny width, 12 + 12 steps: stage-1 densify,
# the node downsampling and the adoption of the node positions, then
# main-stage densify, node densify, an opacity reset and SH steps
TINY = TrainConfig(
    sh_degree=1, hyper_dim=2, node_num=16, gaussian_capacity=256,
    node_gauss_capacity=128, iterations=12, warm_up=2, node_warm_up=4,
    iterations_node_sampling=8, iterations_node_rendering=12,
    densification_interval=3, densify_from_iter=2, densify_until_iter=10,
    opacity_reset_interval=6, normal_dist_from_iter=3,
    oneup_sh_degree_step=4, node_force_densify_prune_step=5,
    raster=RasterConfig(tile_cap=256, chunk=64))
SIZE = dict(H=32, W=32, n_surfels=1_000, n_cams=4, n_times=3)
EVERY = 7            # checkpoints at steps 7, 14, 21 and 24


@pytest.fixture(scope="module")
def data():
    return conv.make_data("cpu", **SIZE)


def _stopping(tr, after: int):
    """``tr`` whose step() raises once it has taken ``after`` steps."""
    step, n = tr.step, [0]

    def stop_then():
        if n[0] == after:
            raise KeyboardInterrupt
        n[0] += 1
        return step()
    tr.step = stop_then
    return tr


def _assert_same_run(a, b):
    assert (a.iteration, a.iteration_node) == (b.iteration, b.iteration_node)
    assert a.sampler_state() == b.sampler_state()
    la, lb = (checkpoint.tensor_leaves(t.state) for t in (a, b))
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())


def test_resume_is_bitwise_the_uninterrupted_run(data, tmp_path):
    ref = conv.make_trainer(TINY, data, "cpu")
    assert ref.total_iterations() == 24
    conv.train(ref, conv.new_progress(), str(tmp_path / "ref"), EVERY,
               log=lambda s: None)
    run = str(tmp_path / "run")
    cut = _stopping(conv.make_trainer(TINY, data, "cpu"), after=17)
    with pytest.raises(KeyboardInterrupt):
        conv.train(cut, conv.new_progress(), run, EVERY, log=lambda s: None)
    assert sorted(os.listdir(run)) == ["progress.json", "state_000014.npz"]
    res = conv.make_trainer(TINY, data, "cpu")
    progress = conv.load_progress(res, run)
    assert conv.steps_done(res) == 14 and res.iteration == 4
    conv.train(res, progress, run, EVERY, log=lambda s: None)
    _assert_same_run(res, ref)
    assert progress["wall_train_s"] > 0.0
    assert sorted(os.listdir(run)) == ["progress.json", "state_000024.npz"]


def test_stop_while_saving_keeps_the_last_checkpoint(data, tmp_path,
                                                     monkeypatch):
    """Stopped while state_000014.npz is half written: progress.json still
    names state_000007.npz, which resumes the run; the half-written file
    goes with the next save."""
    run = str(tmp_path / "run")
    saved = checkpoint.save_train_state

    def stopped_at_14(path, state, iteration=0, iteration_node=0):
        if path.endswith("state_000014.npz"):
            with open(path + ".tmp.npz", "wb") as fh:
                fh.write(b"PK\x03\x04 half a checkpoint")
            raise KeyboardInterrupt
        saved(path, state, iteration, iteration_node)

    monkeypatch.setattr(checkpoint, "save_train_state", stopped_at_14)
    tr = conv.make_trainer(TINY, data, "cpu")
    with pytest.raises(KeyboardInterrupt):
        conv.train(tr, conv.new_progress(), run, EVERY, log=lambda s: None)
    monkeypatch.setattr(checkpoint, "save_train_state", saved)
    res = conv.make_trainer(TINY, data, "cpu")
    progress = conv.load_progress(res, run)
    assert progress["state"] == "state_000007.npz"
    assert conv.steps_done(res) == 7
    conv.train(res, progress, run, EVERY, log=lambda s: None)
    assert sorted(os.listdir(run)) == ["progress.json", "state_000024.npz"]
    ref = conv.make_trainer(TINY, data, "cpu")
    conv.train(ref, conv.new_progress(), str(tmp_path / "ref"), EVERY,
               log=lambda s: None)
    _assert_same_run(res, ref)
