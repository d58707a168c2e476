"""PyTorch port, ``TrainM2FInstance.evaluate`` against the JAX package's on the
CPU, for the instance, panoptic and semantic tasks: the same weights (the JAX
init with seeded noise, through ``maskformer_from_jax``) over a generated
2-image val split at 96x128 (``tools.synthetic_tree.write_segments_tree``);
every image's detections or semantic histogram, and the reported metrics.
The weights are random, so the values mean nothing.
"""

import functools

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp

import multishiftseg_tpu.evals.seg_metrics as jax_seg_metrics
from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.models import inference_extras as jax_extras
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.train import instance_trainer as jax_instance_trainer

from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.train import instance_trainer

from test_torch_instance_data import TASKS, _bare, _sorted_detections, catalogs, tree  # noqa: F401

WIDTHS = dict(hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64, dec_layers=3,
              mask_dim=32, transformer_enc_layers=2)


def _perturbed(variables, seed):
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, variables))
    out = {}
    for k in sorted(flat):
        scale = 0.1 if k[-2] in ("sampling_offsets", "attention_weights") else 0.01
        out[k] = (flat[k] + scale * rng.randn(*flat[k].shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


@functools.lru_cache(maxsize=None)
def jax_model(num_classes):
    """The JAX vanilla model and its perturbed variables, once per class count
    (the panoptic and semantic recipes share 19)."""
    jm = JaxMaskFormer(num_classes=num_classes, predictor="vanilla", **WIDTHS)
    variables = jax.jit(lambda key: jm.init({"params": key}, jnp.zeros((1, 32, 32, 3)),
                                            train=False))(jax.random.PRNGKey(0))
    return jm, _perturbed(variables, 6)


@pytest.mark.parametrize("task", list(TASKS))
def test_evaluate_matches_jax(tree, catalogs, monkeypatch, task):
    """``evaluate`` over the 2-image val split at 96x128 with the same weights
    (random, so the values mean nothing): every image's detections, panoptic
    segments or semantic map, and the reported metrics. Predictions in f32 on
    both sides: scores to 1e-5, metrics to 1e-6."""
    cfg = load_config(TASKS[task])
    cfg.data.cityscapes_root = tree
    cfg.train.bf16 = False
    jcfg = jax_load_config(TASKS[task])
    jcfg.data.cityscapes_root = tree
    k = cfg.model.m2f.num_classes
    jm, variables = jax_model(k)
    ref = _bare(jax_instance_trainer.TrainM2FInstance, jcfg, task)
    ref.model, ref.variables = jm, variables
    ours = instance_trainer.TrainM2FInstance(
        cfg, model=MaskFormer(num_classes=k, predictor="vanilla", **WIDTHS),
        dataset_name="unused", device="cpu")
    ours.model.load_state_dict(maskformer_from_jax(variables), strict=True)

    seen = {"ours": [], "ref": []}

    def recorder(mod, attr, side):
        orig = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, **kw: seen[side].append(
            orig(*a, **kw)) or seen[side][-1])

    if task == "semantic":
        recorder(instance_trainer, "hist_info", "ours")
        recorder(jax_seg_metrics, "hist_info", "ref")
    else:
        recorder(instance_trainer, "instance_inference", "ours")
        recorder(jax_extras, "instance_inference", "ref")
    got = ours.evaluate()
    want = ref.evaluate()
    assert len(seen["ours"]) == len(seen["ref"]) == 2
    for a, b in zip(seen["ours"], seen["ref"]):
        if task == "semantic":  # (hist, labeled, correct) of each image
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            a, b = _sorted_detections(a), _sorted_detections(b)
            np.testing.assert_array_equal(a["pred_classes"], b["pred_classes"])
            np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-7)
            np.testing.assert_array_equal(a["pred_masks"], b["pred_masks"].astype(bool))
    want = {k: v for k, v in want.items() if k != "AP_per_class"}
    got = {k: v for k, v in got.items() if k != "AP_per_class"}
    assert got.keys() == want.keys()
    expect = {"semantic": {"mIoU", "pixel_acc"}, "instance": {"AP", "AP50", "AP75"},
              "panoptic": {"AP", "PQ", "SQ", "RQ", "PQ_th", "PQ_st", "n_classes"}}[task]
    assert expect <= set(got)
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
