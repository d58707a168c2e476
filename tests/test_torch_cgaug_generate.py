"""PyTorch port, CG-Aug's generation loop (``multishiftseg_torch/cgaug/
{generate,weights}.py``) against the JAX package's, on the CPU.

* The SD pipeline at tiny widths (``test_torch_sd.py``'s towers): 4 DDIM
  steps with guidance 9.0 and the decode within 1e-4 of scale, and
  ``SDControlNetGenerator.generate`` with JAX's x_T draws patched in (the
  uint8 image equal wherever the float image is clear of an integer).
* ``make_m2f_detector`` on a tiny Mask2Anomaly (JAX's seeded variables
  through ``maskformer_from_jax``): the anomaly map within 1e-4 of its scale
  (measured 2.9e-5: f32 sums in another order through the R-50 trunk, the
  deformable encoder and the masked decoder; ``test_torch_spatial.py`` holds
  the same forward at 2e-4).
* ``MultiShiftGenerator`` with the same stub backends and seed in both
  packages: the same accept / reject sequence (both gates, retries, failures),
  statistics, images, masks and files, resume included.
* The whole slice at tiny widths: the port's ``SDControlNetGenerator``,
  ``SAMSegmenter`` and detector against JAX's on the same weights, with JAX's
  x_T draws patched in: per attempt the prompt, the pasted mask, the SAM IoU
  and the detector's mean score before their thresholds, then the accepted
  image and the written files.
* ``main``: ``--backend real`` with ``build_real_backends`` patched (its
  ``--device`` passed on), ``--backend trainable`` refused, and
  ``fetch_weight``, which reads local files only.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from multishiftseg_tpu.cgaug import ade20k_source as jade
from multishiftseg_tpu.cgaug import clip_text as jclip
from multishiftseg_tpu.cgaug import generate as jgenerate
from multishiftseg_tpu.cgaug import sam as jsam
from multishiftseg_tpu.cgaug import sd_pipeline as jpipe
from multishiftseg_tpu.cgaug import weights as jweights
from multishiftseg_tpu.convert.sam import convert_sam
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer

from multishiftseg_torch.cgaug import ade20k_source, clip_text, generate, sam, sd_pipeline, weights
from multishiftseg_torch.convert.from_jax import maskformer_from_jax
from multishiftseg_torch.models.maskformer import MaskFormer

from test_torch_cgaug_labels import write_ade_tree
from test_torch_sd import (N_STEPS, SAMPLER_RTOL, nchw, nhwc, rel_err,  # noqa: F401
                           seeded_state_dict, towers, write_tiny_vocab)
from test_torch_swin import seeded_variables

# R-18 where the detector's default is R-50: the same wrapping and tail at a
# third of JAX's compile time
M2F_TINY = dict(num_classes=19, backbone="resnet18", hidden_dim=32, num_queries=8, nheads=4,
                dim_feedforward=64, dec_layers=3, mask_dim=32, transformer_enc_layers=1)
HW = (64, 64)
DETECTOR_RTOL = 1e-4
IOU_TOL = 1e-3  # SAM's masks may differ at logits within rounding of 0
# each package's gate scores its own image, and the images may differ by one
# level where the float image is within rounding of an integer (measured:
# 6.8e-4 on a mean of -0.41, from under 0.1% of pixels)
SCORE_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def city_frame(seed, hw=HW):
    """A Cityscapes colour label (sky over road, a car) and its trainIds."""
    g = np.random.RandomState(seed)
    h, w = hw
    color = np.zeros((h, w, 3), np.uint8)
    color[:] = (70, 130, 180)
    color[h // 2:] = (128, 64, 128)
    y, x = g.randint(h // 2, h - 8), g.randint(0, w - 20)
    color[y:y + 8, x:x + 20] = (0, 0, 142)
    tid = np.full((h, w), 10, np.uint8)
    tid[h // 2:] = 0
    tid[y:y + 8, x:x + 20] = 13
    return color, tid


@pytest.fixture(scope="module")
def jax_pipeline(towers):
    _, params, (jucfg, jvcfg, jccfg) = towers
    return jpipe.ControlNetPipeline(params, jucfg, jvcfg, jccfg,
                                    sampler=jpipe.SamplerConfig(steps=N_STEPS))


def test_guided_sampler_and_decode_match_jax(towers, jax_pipeline):
    """4 DDIM steps with guidance 9.0 from one x_T, then the decode."""
    ldm = towers[0]
    pipe = sd_pipeline.ControlNetPipeline(ldm, sd_pipeline.SamplerConfig(steps=N_STEPS))
    g = np.random.RandomState(4)
    x_T = g.randn(1, 8, 8, 4).astype(np.float32)
    hint = g.rand(1, 64, 64, 3).astype(np.float32)
    ctx_c, ctx_u = g.randn(2, 1, 77, 16).astype(np.float32)
    want = jax_pipeline.sample(jnp.asarray(x_T), jnp.asarray(hint), ctx_c, ctx_u)
    got = pipe.sample(nchw(x_T), nchw(hint), torch.from_numpy(ctx_c), torch.from_numpy(ctx_u))
    assert rel_err(nhwc(got), want) <= SAMPLER_RTOL
    want_img = jax_pipeline.decode(want)
    got_img = pipe.decode(nchw(np.asarray(want)))
    assert rel_err(nhwc(got_img), want_img) <= SAMPLER_RTOL


def jax_latent_draws(seed):
    """JAX's x_T draws of ``SDControlNetGenerator(seed=seed)``, one a call, as
    ``sd_pipeline.draw_latent_noise`` replacements (NCHW)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(generator, shape, device):
        state["key"], key = jax.random.split(state["key"])
        n, c, h, w = shape
        return nchw(np.asarray(jax.random.normal(key, (n, h, w, c)))).to(device)

    return draw


def test_generator_end_to_end_matches_jax(towers, jax_pipeline, tmp_path, monkeypatch):
    """``SDControlNetGenerator.generate`` with JAX's x_T draws patched in: the
    uint8 image equals JAX's wherever JAX's float image lies further than the
    decode tolerance (1e-4 of 255) from an integer, the truncation's threshold."""
    ldm = towers[0]
    write_tiny_vocab(tmp_path)
    tok, jtok = clip_text.load_tokenizer(str(tmp_path)), jclip.load_tokenizer(str(tmp_path))
    monkeypatch.setattr(sd_pipeline, "draw_latent_noise", jax_latent_draws(5))
    gen = sd_pipeline.SDControlNetGenerator(ldm, tok, seed=5, device="cpu",
                                            sampler=sd_pipeline.SamplerConfig(steps=N_STEPS))
    jgen = jpipe.SDControlNetGenerator(None, jtok, pipeline=jax_pipeline, seed=5)
    label = np.random.RandomState(6).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    compared = 0
    for prompt in ("hello world", "a dash cam image"):
        key_before = jgen._key
        img, jimg = gen.generate(label, prompt), jgen.generate(label, prompt)
        assert img.dtype == np.uint8 and img.shape == (64, 64, 3)
        # JAX's float image of the same call
        hint = jnp.asarray(label[None], jnp.float32) / 255.0
        z = jax_pipeline.generate_latents(
            hint, jnp.asarray(jtok([f"{prompt}, {jgen.A_PROMPT}"])),
            jnp.asarray(jtok([jgen.N_PROMPT])), jax.random.split(key_before)[1])
        f = np.asarray(jax_pipeline.decode(z)[0])
        assert np.array_equal(f.astype(np.uint8), jimg)
        margin = np.minimum(f - np.floor(f), np.ceil(f) - f)
        clear = (margin > SAMPLER_RTOL * 255) | (f == 0) | (f == 255)
        assert np.array_equal(img[clear], jimg[clear])
        assert np.abs(img.astype(np.int16) - jimg).max() <= 1
        compared += int(clear.sum())
    assert compared > 0.9 * 2 * label.size


@pytest.fixture(scope="module")
def detectors():
    """(port, JAX) detectors on one tiny Mask2Anomaly's weights."""
    jm = JaxMaskFormer(**M2F_TINY)
    variables = seeded_variables(jm, 21, jnp.zeros((1, *HW, 3)), train=False)
    model = MaskFormer(**M2F_TINY)
    model.load_state_dict(maskformer_from_jax(variables), strict=True)
    return (generate.make_m2f_detector(model, device="cpu"),
            jgenerate.make_m2f_detector(variables, jm))


def test_detector_matches_jax(detectors):
    """A 60x50 image (padded to 64x64 and cropped back) and a 64x64 one."""
    g = np.random.RandomState(22)
    for hw in ((60, 50), HW):
        image = g.randint(0, 256, (*hw, 3)).astype(np.uint8)
        got = detectors[0].anomaly_score(image)
        want = detectors[1].anomaly_score(image)
        assert got.shape == want.shape == hw and got.dtype == np.float32
        assert rel_err(got, want) <= DETECTOR_RTOL


class StubDiffusion:
    """A deterministic image of the label and the prompt's length."""

    def generate(self, seg, prompt):
        return ((seg.astype(np.int64) * 3 + len(prompt)) % 256).astype(np.uint8)


class StubSource:
    def __init__(self):
        self.masks = [np.pad(np.ones((6 + k, 9), np.uint8), 2) for k in range(4)]

    def sample(self, rng):
        k = int(rng.integers(4))
        return self.masks[k], ("sofa", "animal", "boat", "lamp")[k]


class StubSegmenter:
    """The box itself, its right part dropped for some images: IoU 1 or about 0.4."""

    def segment_box(self, image, box):
        m = np.zeros(image.shape[:2], bool)
        x0, y0, x1, y1 = box
        cut = x1 + 1 if int(image.sum()) % 3 else x0 + (x1 - x0 + 1) * 2 // 5
        m[y0:y1 + 1, x0:cut] = True
        return m


class StubDetector:
    def anomaly_score(self, image):
        return (image[..., 0].astype(np.float32) - 128.0) / 32.0


def stub_generators(seed, **cfg):
    kw = dict(seed=seed, paste_min_size=10, paste_max_size=24, **cfg)
    backends = dict(segmenter=StubSegmenter(), detector=StubDetector())
    return (generate.MultiShiftGenerator(StubDiffusion(), StubSource(),
                                         generate.GenerationConfig(**kw), **backends),
            jgenerate.MultiShiftGenerator(StubDiffusion(), StubSource(),
                                          jgenerate.GenerationConfig(**kw), **backends))


@pytest.mark.parametrize("seed,cfg", [(0, {}), (3, {"score_threshold": 0.5}),
                                      (5, {"max_retries": 2, "iou_threshold": 0.95})])
def test_generator_decisions_match_jax(seed, cfg):
    gen, jgen = stub_generators(seed, **cfg)
    for k in range(4):
        color, _ = city_frame(seed + k)
        got, want = gen.generate(color), jgen.generate(color)
        assert (got is None) == (want is None)
        if got is not None:
            assert got[2:] == want[2:]
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert gen.stats == jgen.stats
    assert gen.rng.bit_generator.state == jgen.rng.bit_generator.state


def write_city_frames(root, n=2, city="aachen"):
    gt = root / "gtFine" / "train" / city
    gt.mkdir(parents=True)
    colors, tids = [], []
    for i in range(n):
        color, tid = city_frame(40 + i)
        stem = f"{city}_{i:06d}_000019"
        colors.append(str(gt / f"{stem}_gtFine_color.png"))
        tids.append(str(gt / f"{stem}_gtFine_labelTrainIds.png"))
        Image.fromarray(color).save(colors[-1])
        Image.fromarray(tid).save(tids[-1])
    return colors, tids


def test_run_writes_what_jax_writes(tmp_path):
    colors, tids = write_city_frames(tmp_path / "cs", n=3)
    gen, jgen = stub_generators(1, max_retries=2, score_threshold=0.0)
    for g, out in ((gen, tmp_path / "port"), (jgen, tmp_path / "jax")):
        g.run(colors, tids, str(out / "img"), str(out / "lbl"))
    assert gen.stats == jgen.stats and gen.stats["failed_images"] > 0
    for sub in ("img", "lbl"):
        files = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert files == sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        for name in files:
            a = np.asarray(Image.open(tmp_path / "port" / sub / name))
            assert np.array_equal(a, np.asarray(Image.open(tmp_path / "jax" / sub / name)))
    before = dict(gen.stats)
    gen.run(colors, tids, str(tmp_path / "port" / "img"), str(tmp_path / "port" / "lbl"))
    # resumed: only the frames without an image are attempted again
    assert (gen.stats["attempts"] - before["attempts"]
            <= gen.cfg.max_retries * before["failed_images"])


class Recorder:
    """Wraps a backend, recording what it returns."""

    def __init__(self, inner, method):
        self.inner, self.calls = inner, []
        setattr(self, method, self._call(getattr(inner, method)))

    def _call(self, fn):
        def call(*args):
            out = fn(*args)
            self.calls.append((args, out))
            return out
        return call


@pytest.fixture(scope="module")
def tiny_backends(towers, jax_pipeline, detectors, tmp_path_factory):
    """The tiny real backends of both packages on the same weights; the JAX
    diffusion backend on the sampler tests' compiled pipeline."""
    vocab = tmp_path_factory.mktemp("vocab")
    write_tiny_vocab(vocab)
    diffusion = sd_pipeline.SDControlNetGenerator(
        towers[0], clip_text.load_tokenizer(str(vocab)), seed=31, device="cpu",
        sampler=sd_pipeline.SamplerConfig(steps=N_STEPS))
    jdiffusion = jpipe.SDControlNetGenerator(None, jclip.load_tokenizer(str(vocab)),
                                             pipeline=jax_pipeline, seed=31)
    net = sam.SAM(sam.tiny_sam_config()).eval()
    sam_params, _ = convert_sam(seeded_state_dict(net, 32), jsam.tiny_sam_config())
    return ((diffusion, sam.SAMSegmenter(net, device="cpu"), detectors[0]),
            (jdiffusion, jsam.SAMSegmenter(sam_params, jsam.tiny_sam_config()), detectors[1]))


def test_whole_slice_matches_jax(tiny_backends, tmp_path, monkeypatch):
    """Two frames through ``run`` with every gate's value recorded. The gates
    pass everything (IoU above -1, score at least -1e9), so each attempt runs
    all three backends; the values before the thresholds are compared."""
    monkeypatch.setattr(sd_pipeline, "draw_latent_noise", jax_latent_draws(31))
    root = write_ade_tree(tmp_path / "ade", 33)
    colors, tids = write_city_frames(tmp_path / "cs", n=2)
    runs = {}
    for name, (diffusion, segmenter, detector), pkg in (
            ("port", tiny_backends[0], generate), ("jax", tiny_backends[1], jgenerate)):
        rec = (Recorder(diffusion, "generate"), Recorder(segmenter, "segment_box"),
               Recorder(detector, "anomaly_score"))
        src = (ade20k_source if name == "port" else jade).ADE20KAnomalySource(str(root))
        cfg = pkg.GenerationConfig(seed=34, iou_threshold=-1.0, score_threshold=-1e9,
                                   paste_min_size=12, paste_max_size=30)
        gen = pkg.MultiShiftGenerator(rec[0], src, cfg, segmenter=rec[1], detector=rec[2])
        gen.run(colors, tids, str(tmp_path / name / "img"), str(tmp_path / name / "lbl"))
        runs[name] = (gen.stats, rec)
    (stats, rec), (jstats, jrec) = runs["port"], runs["jax"]
    assert stats == jstats == {"attempts": 2, "accepted": 2, "iou_rejects": 0,
                               "detector_rejects": 0, "failed_images": 0}
    for (args, image), (jargs, jimage) in zip(rec[0].calls, jrec[0].calls):
        assert np.array_equal(args[0], jargs[0]) and args[1] == jargs[1]  # label, prompt
        assert np.abs(image.astype(np.int16) - jimage).max() <= 1
        assert (image != jimage).mean() < 1e-3
    ious = []
    for (args, mask), (jargs, jmask), (_, _, pasted) in zip(rec[1].calls, jrec[1].calls,
                                                            _pasted_masks(tmp_path)):
        assert np.array_equal(args[1], jargs[1])  # the pasted object's box
        assert (mask != jmask).mean() < 1e-3
        ious.append((generate._iou(mask, pasted), jgenerate._iou(jmask, pasted)))
    scores = []
    for ((args, score), (jargs, jscore), (_, _, pasted)) in zip(rec[2].calls, jrec[2].calls,
                                                                _pasted_masks(tmp_path)):
        # on the JAX image, the port's detector is JAX's
        assert rel_err(rec[2].inner.anomaly_score(jargs[0]), jscore) <= DETECTOR_RTOL
        scores.append((float(score[pasted == 1].mean()), float(jscore[pasted == 1].mean())))
    # the gate values before the reference's thresholds, and the decisions
    # where JAX's value is clear of the threshold by more than the difference
    for (iou, jiou), (sc, jsc) in zip(ious, scores):
        assert abs(iou - jiou) <= IOU_TOL and abs(sc - jsc) <= SCORE_TOL
        if abs(jiou - 0.7) > IOU_TOL:
            assert (iou > 0.7) == (jiou > 0.7)
        if abs(jsc + 3.02) > SCORE_TOL:
            assert (sc >= -3.02) == (jsc >= -3.02)
    assert len(rec[2].calls) == 2
    for sub in ("img", "lbl"):
        for p in sorted((tmp_path / "jax" / sub).iterdir()):
            a = np.asarray(Image.open(tmp_path / "port" / sub / p.name)).astype(np.int16)
            b = np.asarray(Image.open(p)).astype(np.int16)
            assert np.abs(a - b).max() <= (0 if sub == "lbl" else 1)


def _pasted_masks(tmp_path):
    """(stem, trainIds, pasted mask) of each label the JAX run wrote."""
    for p in sorted((tmp_path / "jax" / "lbl").iterdir()):
        tid = np.asarray(Image.open(p))
        yield p.name, tid, (tid == 254).astype(np.uint8)


def test_main_real_backend_and_refusals(tmp_path, monkeypatch):
    """``main --backend real`` over a city batch with ``build_real_backends``
    patched: the DiverseCityscapes layout, 254 on the pasted pixels, resume;
    ``--device`` reaches the backends; ``--backend trainable`` raises."""
    colors, _ = write_city_frames(tmp_path / "cs", n=2)
    root = write_ade_tree(tmp_path / "ade", 35)
    devices = []

    def fake_backends(download_dir, device="cuda"):
        devices.append((download_dir, device))
        return StubDiffusion(), StubSegmenter()

    monkeypatch.setattr(weights, "build_real_backends", fake_backends)
    out = tmp_path / "gen"
    argv = ["--cityscapes_root", str(tmp_path / "cs"), "--ade_root", str(root),
            "--out_root", str(out), "--split", "train", "--city_batch", "0",
            "--download_dir", str(tmp_path / "w"), "--device", "cpu",
            "--paste_min_size", "10", "--paste_max_size", "24", "--seed", "3"]
    stats = generate.main(argv)
    assert devices == [(str(tmp_path / "w"), "cpu")]
    assert stats["attempts"] >= 2 and stats["accepted"] + stats["failed_images"] == 2
    imgs = sorted((out / "leftImg8bit" / "train" / "aachen").iterdir())
    assert len(imgs) == stats["accepted"] > 0
    for img in imgs:
        lbl = out / "gtFine" / "train" / "aachen" / img.name.replace(
            "_leftImg8bit.png", "_gtFine_labelTrainIds.png")
        assert (np.asarray(Image.open(lbl)) == 254).any()
    again = generate.main(argv)
    assert again["attempts"] <= 5 * stats["failed_images"]  # resumed
    with pytest.raises(NotImplementedError, match="5b"):
        generate.main(argv + ["--backend", "trainable"])


def test_fetch_weight_reads_local_files_only(tmp_path):
    dest = tmp_path / "sam_vit_h_4b8939.pth"
    dest.write_bytes(b"x")
    assert weights.fetch_weight("sam_vit_h", str(tmp_path)) == str(dest)
    with pytest.raises(FileNotFoundError) as err:
        weights.fetch_weight("control_sd15_seg", str(tmp_path))
    assert "huggingface.co/lllyasviel" in str(err.value)
    assert str(tmp_path / "control_sd15_seg.pth") in str(err.value)
    with pytest.raises(FileNotFoundError, match="Google Drive"):
        weights.fetch_weight("bt-f-xl", str(tmp_path))
    with pytest.raises(KeyError):
        weights.fetch_weight("nope", str(tmp_path))
    assert weights.WEIGHT_URLS == jweights.WEIGHT_URLS
    with pytest.raises(FileNotFoundError):
        weights.build_real_backends(str(tmp_path / "empty"), device="cpu")
