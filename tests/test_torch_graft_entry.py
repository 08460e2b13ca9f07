"""``lipsync_tpu_torch/tools/graft_entry.py``, the port of the root
``__graft_entry__.py``, on the CPU:

- ``entry()`` hands back the flagship forward and its example inputs at
  the shapes of ``tests/test_graft_entry.py`` (the forward itself runs on
  the card: full width is minutes here);
- ``dryrun_multichip(2, device_type="cpu")`` runs its train step over two
  gloo ranks with the JAX file's checks (step 1, finite loss and
  parameters), says where it ran, and its serving paths over two CPU
  shards give finite logits of their shapes within 2e-5 of one device
  (``tests/test_predictor.py:293``; shared encoding within 1e-4,
  ``:517``);
- without CUDA both raise unless asked for the CPU.
"""

import pytest
import torch

from lipsync_tpu_torch.tools import graft_entry


def test_entry_shapes():
    fn, (visual, audio) = graft_entry.entry(device="cpu")
    assert callable(fn)
    assert visual.shape == (8, 32, 96, 96, 3)
    assert audio.shape[0] == 8 and tuple(audio.shape) == (8, 80, 128, 1)
    assert visual.dtype == audio.dtype == torch.float32


def test_dryrun_multichip_over_two_gloo_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks
    report = graft_entry.dryrun_multichip(2, device_type="cpu")
    step = report["train_step"]
    assert step["backend"] == "gloo" and step["devices"] == ["cpu", "cpu"]
    assert step["step"] == 1 and step["batch"] == 4
    assert torch.isfinite(torch.tensor(step["loss"]))
    serving = report["serving"]
    assert serving["devices"] == ["cpu", "cpu"]
    assert serving["score_logits"]["shape"] == [3]
    assert serving["dispatch_track_logits"]["shape"] == [4]
    assert serving["shared_score_track_logits"]["shape"] == [4]
    assert serving["score_logits"]["max_abs_vs_one_device"] <= 2e-5
    assert serving["dispatch_track_logits"]["max_abs_vs_one_device"] <= 2e-5
    assert serving["shared_score_track_logits"][
        "max_abs_vs_one_device"] <= 1e-4


def test_without_cuda_both_raise_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
    assert graft_entry._initialized_device_count() == 0
