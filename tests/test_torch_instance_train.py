"""PyTorch port, the vanilla Mask2Former recipes end to end on the CPU: the
training CLI (``python -m multishiftseg_torch.train.cli --device cpu``) on each
of exps/m2f_{instance,panoptic,semantic}.yaml, narrowed by a YAML that
includes it, over a generated Cityscapes tree
(``tools.synthetic_tree.write_segments_tree``): one epoch, the ``last``
checkpoint and ``scalars.csv``; a resume from ``last`` whose epoch continues
the step count with the saved optimizer state; then ``--run evaluate`` on the
val split from the checkpoint's weights.

Tiny widths (hidden 32, 24 queries: at least the semantic recipe's 20 slots;
3 decoder layers, 1 encoder layer; R-50 at its own widths), 2 images of 64x64
a step, 64 points, fp32.
"""

import os

import numpy as np
import pytest
import torch

from multishiftseg_torch.data.registry import DatasetCatalog
from multishiftseg_torch.tools.synthetic_tree import write_segments_tree
from multishiftseg_torch.train import cli
from multishiftseg_torch.train.checkpoint import CheckpointManager

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WIDTHS = dict(hidden_dim=32, num_queries=24, nheads=4, dim_feedforward=64, dec_layers=4,
              mask_dim=32, transformer_enc_layers=1, train_num_points=64)
EXPECT = {"instance": {"AP", "AP50", "AP75"},
          "panoptic": {"AP", "PQ", "SQ", "RQ", "PQ_th", "PQ_st"},
          "semantic": {"mIoU", "pixel_acc"}}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_segments_tree(tmp_path_factory.mktemp("segments"), seed=3,
                               frames={"train": 4, "val": 1}, hw=(96, 128),
                               things=8)["cityscapes_root"]


@pytest.mark.parametrize("recipe", list(EXPECT))
def test_cli_trains_resumes_and_evaluates_the_vanilla_recipe(tree, tmp_path, monkeypatch,
                                                             recipe):
    import yaml

    monkeypatch.chdir(tmp_path)

    def write(n_epochs):
        y = {"base": os.path.join(REPO, "exps", f"m2f_{recipe}.yaml"),
             "data": {"cityscapes_root": tree, "crop_size": [64, 64], "num_workers": 2},
             "model": {"m2f": dict(WIDTHS, max_instances=8 if recipe != "semantic" else 20)},
             "train": {"n_epochs": n_epochs, "train_batch": 2, "bf16": False}}
        path = tmp_path / f"tiny{n_epochs}.yaml"
        path.write_text(yaml.safe_dump(y))
        return str(path)

    run = ["--model", "m2f", "--id", "run0", "--device", "cpu"]
    try:
        first = cli.main(run + ["--cfg", write(1)])
        ckpt = CheckpointManager(os.path.join("ckpts", "run0"))
        saved = ckpt.restore("last")
        assert np.isfinite(first["loss"]) and saved["epoch"] == 0 and saved["step"] == 2
        assert os.path.isfile("outputs/run0/log.txt")
        with open(os.path.join("ckpts", "run0", "scalars.csv")) as f:
            assert f.read().splitlines()[1].startswith("0,train/loss,")
        second = cli.main(run + ["--cfg", write(2), "--resume", "last"])
        resumed = ckpt.restore("last")
        assert np.isfinite(second["loss"]) and resumed["epoch"] == 1 and resumed["step"] == 4
        # the resumed epoch stepped the saved moments further
        assert all(int(s["step"]) == 4 for s in resumed["optimizer"]["state"].values())
        metrics = cli.main(run + ["--cfg", write(2), "--run", "evaluate",
                                  "--weight_path", ckpt.path("last")])
        assert EXPECT[recipe] <= set(metrics)
        values = [metrics[k] for k in EXPECT[recipe]]
        assert all(np.isnan(v) or 0.0 <= v <= 1.0 for v in values)
    finally:
        for name in DatasetCatalog.list():
            DatasetCatalog.remove(name)
