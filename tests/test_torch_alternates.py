"""PyTorch port, the alternate backbones and heads against the JAX package on the CPU.

``MaskFormer`` in the routings JAX has (ResNet-18 / 34 / 101 and a tiny Swin;
the ``msdeformattn``, ``fpn`` and ``transformer_encoder`` pixel decoders; the
``gma``, ``vanilla`` and ``standard`` predictors) at tiny head widths (hidden
32, 8 queries, 3 decoder and 2 encoder layers) on 2 x 64 x 64 images, each
output within 1e-4 of its scale, with the masked-attention decoders' deciding
logits clear of 0; the model registry; ``resize_nearest`` and
``confusion_matrix`` bit for bit; the AdamW groups
against JAX's ``m2f_param_rules``; and every recipe of ``exps/`` built on the
``meta`` device (``DeepV3Plus`` against JAX: ``test_torch_deepv3_generic.py``).
Weights are seeded numpy draws in the JAX init's shapes
(``test_torch_swin.seeded_variables``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.evals.seg_metrics import confusion_matrix as jax_confusion_matrix
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.ops.resize import resize_nearest as jax_resize_nearest
from multishiftseg_tpu.train.state import m2f_param_rules as jax_param_rules

from multishiftseg_torch.convert.from_jax import maskformer_from_jax, maskformer_rules, port_key
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.evals.seg_metrics import confusion_matrix, hist_info
from multishiftseg_torch.models import MODEL_REGISTRY
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.deepv3_generic import DeepV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer, maskformer_from_config
from multishiftseg_torch.models.swin import SwinTransformer
from multishiftseg_torch.ops.resize import resize_bilinear_nchw, resize_nearest
from multishiftseg_torch.train.state import build_m2f_official_optimizer

from test_torch_swin import micro_swin, rel_err, seeded_variables

HEADS = dict(num_classes=19, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
             dec_layers=3, mask_dim=32, transformer_enc_layers=2)
IMG = (2, 64, 64)
ROUTINGS = [("resnet101", "msdeformattn", "gma"), ("resnet18", "fpn", "vanilla"),
            ("resnet34", "transformer_encoder", "standard"),
            ("swin_micro", "msdeformattn", "vanilla"), ("swin_micro", "fpn", "standard"),
            ("swin_micro", "transformer_encoder", "gma")]


def _routing(r):
    return dict(HEADS, backbone=r[0], pixel_decoder=r[1], predictor=r[2])


def _assert_deciding_logits_clear(got, want, sizes):
    """Masked attention thresholds each prediction's mask logits, resized to
    the next layer's level, at 0: every deciding logit lies clear of 0
    compared with the frameworks' difference, and the masks agree."""
    ours = [resize_bilinear_nchw(torch.as_tensor(np.array(m)), sizes[i % 3])
            for i, m in enumerate(got)]
    ref = [resize_bilinear_nchw(torch.as_tensor(np.array(m)), sizes[i % 3])
           for i, m in enumerate(want)]
    margin = min(float(x.abs().min()) for x in ref)
    diff = max(float((g - x).abs().max()) for g, x in zip(ours, ref))
    assert margin > 10 * diff, f"mask logit {margin:.3g} vs difference {diff:.3g}"
    for i, (g, x) in enumerate(zip(ours, ref)):
        assert torch.equal(g > 0, x > 0), f"attention mask {i} differs"


@pytest.mark.parametrize("routing", ROUTINGS, ids=["-".join(r) for r in ROUTINGS])
def test_maskformer_routing_matches_jax(routing):
    cfg = _routing(routing)
    img = np.random.RandomState(0).randn(*IMG, 3).astype(np.float32)
    with micro_swin():
        jm = JaxMaskFormer(**cfg)
        variables = seeded_variables(jm, 1, jnp.asarray(img[:1]), train=False)
        ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(img))
        port = MaskFormer(**cfg).eval()
    port.load_state_dict(maskformer_from_jax(variables), strict=True)
    with torch.no_grad():
        x = torch.from_numpy(img)
        out = port(x)
        _, _, ms = port.sem_seg_head.pixel_decoder(port.backbone(x.permute(0, 3, 1, 2)))
    keys = sorted(k for k in ref if k != "aux_outputs")
    assert keys == sorted(k for k in out if k != "aux_outputs")
    assert ("pred_logits_ood" in keys) == (routing[2] == "gma")
    assert len(out["aux_outputs"]) == len(ref["aux_outputs"])
    if routing[2] != "standard":  # the masked-attention decoders
        _assert_deciding_logits_clear([a["pred_masks"] for a in out["aux_outputs"]],
                                      [a["pred_masks"] for a in ref["aux_outputs"]],
                                      [tuple(t.shape[-2:]) for t in ms])
    for got, want in [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"])):
        for k in keys:
            # f32 stacks summed in another order; flax's norms take the
            # variance as E[x^2] - E[x]^2
            assert rel_err(got[k].numpy(), want[k]) < 1e-4, k


@pytest.mark.parametrize("routing", ROUTINGS[1:], ids=["-".join(r) for r in ROUTINGS[1:]])
def test_adamw_groups_equal_m2f_param_rules(routing):
    """Every parameter, through the converter's name map: the port's group (lr
    multiplier, weight decay or not) equals the JAX rule for its flax path:
    the backbone at 0.1x, no decay for norms, the bias tables and embeddings."""
    cfg = _routing(routing)
    with micro_swin():
        jm = JaxMaskFormer(**cfg)
        params = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 64, 64, 3)), train=False))["params"]
        model = MaskFormer(**cfg)
    base, wd = 1e-4, 0.05
    opt = build_m2f_official_optimizer(model, base_lr=base, weight_decay=wd)
    groups = {n: (g["lr"], g["weight_decay"]) for g in opt.param_groups for n in g["names"]}
    paths = list(flax.traverse_util.flatten_dict(params))
    rules = maskformer_rules(paths)
    seen = set()
    for path in paths:
        want = jax_param_rules(path)
        name = port_key(path, rules)
        seen.add(name)
        assert groups[name][0] == pytest.approx(base * want["lr_mult"]), name
        assert groups[name][1] == pytest.approx(wd if want["wd"] is None else want["wd"]), name
    assert seen == set(groups)


def test_model_registry_names_the_jax_registry():
    from multishiftseg_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    with torch.device("meta"):
        for name in ("DeepR50V3PlusD_m1", "DeepSRNX50V3PlusD_m1", "DeepSRNX101V3PlusD_m1"):
            model = MODEL_REGISTRY[name]()
            assert isinstance(model, DeepV3Plus)
    assert isinstance(model.trunk.layer3[0].conv2, torch.nn.Conv2d)
    assert model.trunk.layer3[0].conv2.dilation == (2, 2) and len(model.trunk.layer3) == 23


# ---------------------------------------------------------------------------
# ops and metrics


@pytest.mark.parametrize("hw_in,hw_out", [((5, 7), (13, 11)), ((12, 20), (7, 9)),
                                          ((3, 3), (10, 10)), ((64, 64), (33, 31)),
                                          ((24, 36), (48, 72)), ((7, 5), (21, 15)),
                                          ((9, 6), (9, 6))])
def test_resize_nearest_equals_jax(hw_in, hw_out):
    """The source pixels of JAX's rule (floor(i * in / out) in float64), at
    non-integer ratios, downsampling and integer factors, bit for bit."""
    x = np.random.RandomState(sum(hw_in)).randn(2, *hw_in, 3).astype(np.float32)
    ref = np.asarray(jax_resize_nearest(jnp.asarray(x), hw_out))
    ours = resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), hw_out)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)


def test_confusion_matrix_equals_jax():
    rng = np.random.RandomState(6)
    pred = rng.randint(-2, 22, (3, 37, 53))
    gt = rng.randint(0, 19, (3, 37, 53))
    gt[:, :4] = 255
    gt[0, 5:9] = -1
    ours = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(gt), 19)
    ref = np.asarray(jax_confusion_matrix(jnp.asarray(pred), jnp.asarray(gt), 19))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # the numpy API on the clamped predictions
    np.testing.assert_array_equal(ours.numpy(), hist_info(19, np.clip(pred, 0, 18), gt)[0])
    assert int(ours.sum()) == int(((gt >= 0) & (gt < 19)).sum())


# ---------------------------------------------------------------------------
# every recipe


RECIPES = sorted(p.name for p in Path("exps").glob("*.yaml"))


@pytest.mark.parametrize("recipe", RECIPES)
def test_every_recipe_builds_its_model(recipe):
    """Each of the 24 recipes builds its model in the port, on the ``meta``
    device (no weights allocated): the configured backbone, pixel decoder and
    predictor, with the parameter count of the JAX model's init shapes for
    the R-50 and Swin-T ones."""
    cfg = load_config(f"exps/{recipe}")
    with torch.device("meta"):
        if recipe == "deeplab.yaml":
            model = DeepWV3Plus(num_classes=cfg.data.class_num)
        else:
            model = maskformer_from_config(cfg.model.m2f)
    assert all(p.is_meta for p in model.parameters())
    if recipe == "deeplab.yaml":
        return
    m = cfg.model.m2f
    assert isinstance(model.backbone, SwinTransformer) == m.backbone.startswith("swin")
    assert model.pixel_decoder_name == m.pixel_decoder
    assert model.predictor_name == m.transformer_decoder
    if recipe in ("m2f.yaml", "m2f_swin_tiny.yaml"):
        jm = JaxMaskFormer(num_classes=m.num_classes, backbone=m.backbone,
                           dec_layers=m.dec_layers - 1, predictor=m.transformer_decoder)
        params = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 64, 64, 3))))["params"]
        n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(params))
        assert sum(p.numel() for p in model.parameters()) == n_jax
