"""PyTorch port, SAM (``multishiftseg_torch/cgaug/sam.py``) against the JAX
package's ``cgaug/sam.py``, on the CPU.

The port's tiny SAM gets numpy-seeded weights; JAX's params are the same
tensors through the JAX package's checkpoint converter (``convert_sam``), so
the port's module tree is held to segment-anything's names. Tolerances: f32
module outputs within 1e-5 of the output's largest magnitude; the binary masks
(``logits > 0``) equal wherever JAX's logit is further than that from 0. The
predictor's resizes are ``jax.image.resize``'s antialiased bilinear, held
directly on a 1024x2048 -> 512x1024 downsampling and on the mask upsamplings.
At ViT-H's widths the encoder is built on the ``meta`` device: its keys and
shapes, with the keys ``convert_sam`` skips, are the public checkpoint's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multishiftseg_tpu.cgaug import sam as jsam
from multishiftseg_tpu.convert.sam import convert_sam, sam_state_dict_template

from multishiftseg_torch.cgaug import sam
from multishiftseg_torch.convert.from_jax import sam_from_jax
from multishiftseg_torch.ops.resize import resize_bilinear_antialias

from test_torch_sd import MODULE_RTOL, nchw, nhwc, rel_err, seeded_state_dict


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny SAM with seeded weights and JAX's params from them."""
    cfg, jcfg = sam.tiny_sam_config(), jsam.tiny_sam_config()
    model = sam.SAM(cfg).eval()
    sd = seeded_state_dict(model, 10)
    params, skipped = convert_sam(sd, jcfg)
    assert skipped == []
    return model, params, jcfg


def test_window_partition_matches_jax():
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    got, pad = sam.window_partition(torch.from_numpy(x), 3)
    want, jpad = jsam.window_partition(jnp.asarray(x), 3)
    assert pad == jpad and np.array_equal(got.numpy(), np.asarray(want))
    back = sam.window_unpartition(got, 3, pad, (5, 7))
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_relative_position_attention_matches_jax(hw):
    h, w = hw
    g = np.random.RandomState(1)
    dim, heads = 8, 2
    attn = sam.ViTAttention(dim, heads, max(h, w))
    sd = seeded_state_dict(attn, 2)
    with torch.no_grad():  # the tables are zero by default: give them values
        attn.rel_pos_h.normal_(0, 0.5)
        attn.rel_pos_w.normal_(0, 0.5)
    x = g.randn(2, h, w, dim).astype(np.float32)
    d = dim // heads
    params = {"qkv": {"kernel": sd["qkv.weight"].numpy().T.reshape(dim, 3, heads, d),
                      "bias": sd["qkv.bias"].numpy().reshape(3, heads, d)},
              "proj": {"kernel": sd["proj.weight"].numpy().T, "bias": sd["proj.bias"].numpy()},
              "rel_pos_h": attn.rel_pos_h.detach().numpy(),
              "rel_pos_w": attn.rel_pos_w.detach().numpy()}
    want = jsam.ViTAttention(heads).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = attn(torch.from_numpy(x))
    assert rel_err(got.numpy(), want) <= MODULE_RTOL


def test_sam_from_jax_round_trips_the_state_dict(tiny):
    model, params, _ = tiny
    back = sam_from_jax(params, model.cfg)
    sd = model.state_dict()
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_vit_h_keys_and_shapes_are_the_checkpoints():
    """ViT-H's state dict keys and shapes, plus the keys ``convert_sam`` skips,
    are ``sam_state_dict_template(sam_vit_h())``; ``load_sam`` drops exactly
    the skipped keys and refuses any other stray or missing one."""
    with torch.device("meta"):
        model = sam.SAM(sam.sam_vit_h())
    template = sam_state_dict_template(jsam.sam_vit_h())
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    skipped = {k: s for k, s in template.items() if k.startswith(sam.SKIPPED_PREFIXES)}
    assert len(skipped) == 11
    assert {**ours, **skipped} == template
    assert sum(p.numel() for p in model.parameters()) == 641_085_668
    sd = {k: np.broadcast_to(np.float32(0), s) for k, s in template.items()}
    _, jax_skipped = convert_sam(sd, jsam.sam_vit_h())
    assert sorted(jax_skipped) == sorted(skipped)


def test_load_sam_drops_exactly_the_skipped_keys(tiny, tmp_path):
    model, _, _ = tiny
    template = sam_state_dict_template(jsam.tiny_sam_config())
    state = dict(model.state_dict())
    state.update({k: torch.zeros(s) for k, s in template.items()
                  if k.startswith(sam.SKIPPED_PREFIXES)})
    torch.save(state, tmp_path / "sam.pth")
    loaded = sam.load_sam(str(tmp_path / "sam.pth"), model.cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    torch.save({**state, "image_encoder.stray": torch.zeros(1)}, tmp_path / "stray.pth")
    with pytest.raises(RuntimeError, match="stray"):
        sam.load_sam(str(tmp_path / "stray.pth"), model.cfg)
    del state["mask_decoder.iou_token.weight"]
    torch.save(state, tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="iou_token"):
        sam.load_sam(str(tmp_path / "missing.pth"), model.cfg)


@pytest.fixture(scope="module")
def jax_predictor(tiny):
    """One JAX predictor for the module: its encode and decode compile once."""
    _, params, jcfg = tiny
    return jsam.SamPredictor(params, jcfg)


def test_image_encoder_matches_jax(tiny, jax_predictor):
    model, params, _ = tiny
    x = np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32)
    want = jax_predictor._encode(params, x)
    with torch.no_grad():
        got = model.encode_image(nchw(x))
    assert rel_err(nhwc(got), want) <= MODULE_RTOL


def test_box_embedding_and_mask_decoder_match_jax(tiny, jax_predictor):
    model, params, jcfg = tiny
    g = np.random.RandomState(4)
    embed = g.randn(1, 4, 4, 16).astype(np.float32)
    boxes = np.array([[3.0, 5.0, 40.0, 33.0], [0.0, 0.0, 63.0, 63.0]], np.float32)
    sparse, dense, pe = jsam.SAMPromptEncoder(jcfg).apply(
        {"params": params["prompt_encoder"]}, jnp.asarray(boxes))
    with torch.no_grad():
        s, d, p = model.prompt_encoder(torch.from_numpy(boxes))
    assert rel_err(s.numpy(), sparse) <= MODULE_RTOL
    assert rel_err(nhwc(d), dense) <= MODULE_RTOL
    assert rel_err(p[0].permute(1, 2, 0).numpy(), pe) <= MODULE_RTOL
    masks, iou = jax_predictor._decode(params, embed, boxes)
    with torch.no_grad():
        m, i = model.decode_box(nchw(embed), torch.from_numpy(boxes))
    assert m.shape == (2, 4, 16, 16)
    assert rel_err(m.numpy(), masks) <= MODULE_RTOL
    assert rel_err(i.numpy(), iou) <= MODULE_RTOL


@pytest.mark.parametrize("src,dst", [((1024, 2048), (512, 1024)), ((16, 16), (64, 64)),
                                     ((48, 64), (96, 72))])
def test_antialiased_resize_matches_jax(src, dst):
    """SAM's resizes: the 1024x2048 frame's downsampling to 512x1024, the
    low-res masks' 4x upsampling and the crop's resize to the image."""
    x = (np.random.RandomState(5).rand(1, 3, *src) * 255).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 3, *dst), "bilinear")
    got = resize_bilinear_antialias(torch.from_numpy(x), dst)
    assert rel_err(got.numpy(), want) <= MODULE_RTOL


def jax_full_logits(pred, low, hw):
    """JAX ``SamPredictor.predict``'s logits before the threshold."""
    cfg = pred.cfg
    full = jax.image.resize(jnp.asarray(low)[None], (1, 1, cfg.img_size, cfg.img_size),
                            "bilinear")
    full = full[:, :, : pred._input_hw[0], : pred._input_hw[1]]
    return np.asarray(jax.image.resize(full, (1, 1, *hw), "bilinear"))[0]


@pytest.mark.parametrize("hw", [(128, 96), (40, 56)])
def test_predictor_matches_jax(tiny, jax_predictor, hw):
    """``set_image`` (downsampling the longer side 128 -> 64, or upsampling
    56 -> 64) and ``predict(box=...)``: the embedding, the low-res logits, the
    IoU and the masks where JAX's logit is clear of 0."""
    model, params, jcfg = tiny
    image = np.random.RandomState(6).randint(0, 256, (*hw, 3)).astype(np.uint8)
    box = np.array([hw[1] // 5, hw[0] // 4, hw[1] - 9, hw[0] - 7])
    pred, jpred = sam.SamPredictor(model), jax_predictor
    pred.set_image(image)
    jpred.set_image(image)
    assert pred._input_hw == jpred._input_hw
    assert rel_err(nhwc(pred._embed), jpred._embed) <= MODULE_RTOL
    mask, iou, low = pred.predict(box=box)
    jmask, jiou, jlow = jpred.predict(box=box)
    assert mask.shape == jmask.shape == (1, *hw) and mask.dtype == bool
    assert rel_err(low, jlow) <= MODULE_RTOL and rel_err(iou, jiou) <= MODULE_RTOL
    logits = jax_full_logits(jpred, jlow, hw)
    assert np.array_equal(logits > 0, jmask)
    clear = np.abs(logits) > MODULE_RTOL * np.abs(logits).max()
    assert clear.mean() > 0.99 and np.array_equal(mask[clear], jmask[clear])
    seg = sam.SAMSegmenter(model, device="cpu").segment_box(image, box)
    jseg = jsam.SAMSegmenter(params, jcfg)
    jseg.predictor = jpred
    jseg = jseg.segment_box(image, box)
    assert seg.dtype == bool and np.array_equal(seg[clear[0]], jseg[clear[0]])
