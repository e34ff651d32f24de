"""Asynchronous checkpoints of the port (``training/checkpoint.py``): the
state is copied to host memory inside ``save``, so an update right after it
does not reach the file; the writer thread's rename and retention; a second
save waits for the first; an error in the writer surfaces at the next call."""

import threading

import pytest
import torch

from video_super_resolution_tpu_torch.config import ModelConfig, TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.training import checkpoint as ckpt
from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
from video_super_resolution_tpu_torch.training.state import create_train_state
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

TINY = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
            context_channels=(16, 16), depth_channels=8, depth_levels=2,
            fusion_channels=16, sr_channels=16, sr_blocks=2)


def cfg():
    return VSRConfig(model=ModelConfig(**TINY),
                     train=TrainConfig(compute_dtype="float32"))


@pytest.fixture
def slow_save(monkeypatch):
    """torch.save in the writer blocks until the test releases it."""
    gate = threading.Event()
    real = torch.save

    def save(obj, path):
        assert gate.wait(timeout=60), "writer never released"
        real(obj, path)

    monkeypatch.setattr(ckpt.torch, "save", save)
    return gate


def test_update_after_save_does_not_reach_the_file(tmp_path, slow_save):
    st = create_train_state(cfg(), "cpu", seed=0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    mgr.save(1, st, cfg())
    assert mgr._writer.is_alive()            # the write is still pending
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(1.0)
    slow_save.set()
    mgr.wait()
    fresh = create_train_state(cfg(), "cpu", seed=3)
    restored, at = mgr.restore(fresh)
    assert at == 1 and restored.step == 1
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert mgr.restore_config() == cfg()


def test_second_save_waits_and_retention(tmp_path):
    st = create_train_state(cfg(), "cpu", seed=0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, st, cfg())
        assert mgr._writer is not None
    assert mgr.steps() == [2, 3]
    assert mgr._writer is None
    mgr.close()
    assert not [p for p in tmp_path.iterdir() if p.suffix == ".tmp"]


def test_writer_error_is_raised_not_dropped(tmp_path, monkeypatch):
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    st = create_train_state(cfg(), "cpu", seed=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, st)
    with pytest.raises(RuntimeError, match="checkpoint write failed") as err:
        mgr.wait()
    assert isinstance(err.value.__cause__, OSError)
    mgr.wait()                                # reported once
    mgr.save(2, st)
    with pytest.raises(RuntimeError):
        mgr.save(3, st)                       # the next save raises it too
    assert mgr.latest_step() is None
