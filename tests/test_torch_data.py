"""PyTorch port, the training data pipeline against the JAX package on the CPU.

The port's numpy image operations (``data/image_ops.py``) against the OpenCV
calls the JAX package makes, bit for bit (every RGB colour for the colour
conversions); each of the twelve train transforms, the anomaly mix,
``DiverseCityscapes.__getitem__`` under both recipes' Compose, the ``Loader``'s
batch sequence and the native decoder against their JAX counterparts, fed the
same inputs and the same ``numpy.random.Generator`` state. Tolerances: uint8
images, masks, crops, flips, shuffles and pairings equal; float32 images within
1e-5 before ``Normalize`` and 5e-5 after it.
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from multishiftseg_tpu.data import anomaly_mix as jax_mix
from multishiftseg_tpu.data import transforms as jt
from multishiftseg_tpu.data.cityscapes import DiverseCityscapes as JaxDiverseCityscapes
from multishiftseg_tpu.data.loader import Loader as JaxLoader

from multishiftseg_torch.data import anomaly_mix, image_ops, native_io
from multishiftseg_torch.data import transforms as pt
from multishiftseg_torch.data.cityscapes import ID_TO_TRAIN_ID, DiverseCityscapes
from multishiftseg_torch.data.loader import Loader

IMG_ATOL = 1e-5
NORM_ATOL = 5e-5
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


# data/image_ops.py reproduces the arithmetic of one OpenCV build: the vector
# widths that build dispatches on a CPU with AVX-512 decide which pixels take
# fused multiply-adds and which the scalar tails' plain ones (16 pixels for the
# warp, 32 for HSV to RGB, 4 / 8 elements for the blur's row / column pass), and
# its linear resize runs on IPP. The bit-exact comparisons hold only there.
PINNED_OPENCV = "5.0.0"


@pytest.fixture(scope="module")
def opencv_pin():
    """Fail, naming the pinned build, where OpenCV is another build or
    dispatches other vector widths: the comparisons would report bit
    differences that are not the port's."""
    features = cv2.getCPUFeaturesLine().split()
    found = {"version": cv2.__version__, "avx512_skx": "*AVX512-SKX" in features,
             "ipp": bool(cv2.ipp.useIPP())}
    want = {"version": PINNED_OPENCV, "avx512_skx": True, "ipp": True}
    if found != want:
        pytest.fail(f"data/image_ops.py is held bit for bit against OpenCV {PINNED_OPENCV} "
                    f"dispatching AVX512_SKX with IPP on ({want}); this host has {found} "
                    f"(CPU features: {' '.join(features)})", pytrace=False)


def _sample(seed, h=75, w=131, ood=True):
    """(image, mask, gen_image, gen_mask): f32 [0, 1] images and int32 masks
    of train ids, void 255 and, in the generated mask, an OOD (254) block."""
    g = np.random.default_rng(seed)
    img = g.random((h, w, 3), dtype=np.float32)
    gen = g.random((h, w, 3), dtype=np.float32)
    mask = g.integers(0, 19, (h, w)).astype(np.int32)
    gen_mask = g.integers(0, 19, (h, w)).astype(np.int32)
    mask[:3] = 255
    if ood:
        gen_mask[h // 3:h // 2, w // 4:w // 3] = 254
    return img, mask, gen, gen_mask


def _assert_samples(got, want, atol=IMG_ATOL):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if np.issubdtype(b.dtype, np.floating):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- image operations


@pytest.fixture(scope="module")
def every_colour():
    """[4096, 4096, 3] uint8 holding each of the 2^24 RGB colours once."""
    c = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
    return rgb.reshape(4096, 4096, 3)


@pytest.mark.usefixtures("opencv_pin")
def test_colour_conversions_over_every_colour(every_colour):
    np.testing.assert_array_equal(image_ops.rgb2gray(every_colour),
                                  cv2.cvtColor(every_colour, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(image_ops.rgb2hsv(every_colour),
                                  cv2.cvtColor(every_colour, cv2.COLOR_RGB2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                               indexing="ij"), -1).astype(np.uint8).reshape(-1, 3)
    # rows of 256 pixels (all in vector blocks) and of 7 (all in the scalar tail)
    for width in (256, 7):
        rows = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
        np.testing.assert_array_equal(image_ops.hsv2rgb(rows),
                                      cv2.cvtColor(rows, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("hw", [(64, 80), (1, 7), (37, 131)])
def test_equalize_hist_matches_opencv(hw):
    g = np.random.default_rng(hw[1])
    for u in (g.integers(0, 256, hw), g.random(hw) ** 3 * 60 + 100, np.full(hw, 9)):
        u = u.astype(np.uint8)
        np.testing.assert_array_equal(image_ops.equalize_hist(u), cv2.equalizeHist(u))


@pytest.mark.parametrize("hw", [(37, 85), (20, 90), (64, 64), (17, 9)])
@pytest.mark.usefixtures("opencv_pin")
def test_gaussian_blur_matches_opencv(hw):
    """Widths whose rows end in scalar tails of 1-3 (rows) and 1-7 (columns)
    elements, and a 9-wide image, all 3 channels."""
    x = np.random.default_rng(hw[0] * hw[1]).random(hw + (3,), dtype=np.float32)
    for sigma in (0.1, 0.77, 2.3, 4.99):
        np.testing.assert_array_equal(image_ops.gaussian_blur(x, 9, sigma),
                                      cv2.GaussianBlur(x, (9, 9), sigmaX=sigma, sigmaY=sigma))
    np.testing.assert_array_equal(image_ops.gaussian_blur(x, 3, 0), cv2.GaussianBlur(x, (3, 3), 0))
    x64 = x.astype(np.float64) ** 2  # float64 images take OpenCV's float64 filter
    for sigma, k in ((1.7, 9), (0, 3)):
        np.testing.assert_allclose(image_ops.gaussian_blur(x64, k, sigma),
                                   cv2.GaussianBlur(x64, (k, k), sigma), rtol=0, atol=1e-12)
    for sigma in np.linspace(0.1, 5.0, 50):
        np.testing.assert_array_equal(image_ops.gaussian_kernel(9, float(sigma)),
                                      cv2.getGaussianKernel(9, float(sigma), cv2.CV_32F).ravel())


@pytest.mark.parametrize("hw", [(120, 203), (64, 64), (33, 50)])
@pytest.mark.usefixtures("opencv_pin")
def test_resizes_match_opencv(hw):
    """Bilinear on f32 HWC (up, down, the exact halving and the identity),
    nearest on int32 and uint8 masks."""
    g = np.random.default_rng(hw[1])
    x = g.random(hw + (3,), dtype=np.float32) * 255
    m = g.integers(0, 256, hw).astype(np.int32)
    for f in (0.1, 0.5, 0.7, 0.9, 1.0, 1.7):
        dh, dw = max(int(hw[0] * f), 1), max(int(hw[1] * f), 1)
        np.testing.assert_array_equal(image_ops.resize_linear(x, (dh, dw)),
                                      cv2.resize(x, (dw, dh), interpolation=cv2.INTER_LINEAR))
        for mm in (m, m.astype(np.uint8)):
            np.testing.assert_array_equal(
                image_ops.resize_nearest(mm, (dh, dw)),
                cv2.resize(mm, (dw, dh), interpolation=cv2.INTER_NEAREST))
        x64 = x.astype(np.float64) / 255
        got = image_ops.resize_linear(x64, (dh, dw))
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, cv2.resize(x64, (dw, dh), interpolation=cv2.INTER_LINEAR),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("hw", [(257, 395), (120, 203), (64, 15), (31, 16)])
@pytest.mark.usefixtures("opencv_pin")
def test_rotation_matches_opencv(hw):
    """``getRotationMatrix2D`` and ``warpAffine`` (bilinear image, nearest
    mask) at widths with and without a scalar tail, over the recipe's angle
    range and its ends."""
    h, w = hw
    g = np.random.default_rng(h + w)
    x = g.random((h, w, 3), dtype=np.float32)
    m = g.integers(0, 19, (h, w)).astype(np.float32)
    for angle in (-10.0, -3.3, 0.0, 0.5, 7.3, 9.99):
        mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        np.testing.assert_array_equal(image_ops.rotation_matrix((w / 2, h / 2), angle, 1.0), mat)
        np.testing.assert_array_equal(image_ops.warp_affine(x, mat, (w, h)),
                                      cv2.warpAffine(x, mat, (w, h), flags=cv2.INTER_LINEAR))
        np.testing.assert_array_equal(
            image_ops.warp_affine(m, mat, (w, h), nearest=True),
            cv2.warpAffine(m, mat, (w, h), flags=cv2.INTER_NEAREST))
        x64 = x.astype(np.float64)  # the fixed-point remap
        np.testing.assert_allclose(image_ops.warp_affine(x64, mat, (w, h)),
                                   cv2.warpAffine(x64, mat, (w, h), flags=cv2.INTER_LINEAR),
                                   rtol=0, atol=1e-12)


# ---------------------------------------------------------------- transforms

TRANSFORMS = {
    "ColorJitter": lambda m: m.ColorJitter(),
    "GaussianBlur": lambda m: m.GaussianBlur(),
    "RandSharpness": lambda m: m.RandSharpness(),
    "AutoContrast": lambda m: m.AutoContrast(),
    "Equalize": lambda m: m.Equalize(),
    "Resize": lambda m: m.Resize((61, 83)),
    "RandResize": lambda m: m.RandResize(scale=[0.7, 0.8, 0.9, 1.0]),
    "RandCrop": lambda m: m.RandCrop((48, 96)),
    "RandCropIncludeOOD": lambda m: m.RandCropIncludeOOD((48, 96)),
    "RandRotate": lambda m: m.RandRotate(),
    "RandHorizontalFlip": lambda m: m.RandHorizontalFlip(),
    "RandVerticalFlip": lambda m: m.RandVerticalFlip(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.usefixtures("opencv_pin")
def test_train_transform_matches_jax(name):
    """Each transform on the same Sample and generator state, at three seeds:
    equal outputs and the generator left in the same state."""
    for seed in (1, 2, 3):
        want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        want = TRANSFORMS[name](jt)(want_rng, jt.Sample(*_sample(seed)))
        got = TRANSFORMS[name](pt)(got_rng, pt.Sample(*_sample(seed)))
        _assert_samples((got.image, got.mask, got.gen_image, got.gen_mask),
                        (want.image, want.mask, want.gen_image, want.gen_mask))
        assert got_rng.random() == want_rng.random()
        assert got.images()[0] is got.image and len(got.images()) == 2


@pytest.mark.usefixtures("opencv_pin")
def test_crops_resize_when_the_image_is_smaller():
    for make in (lambda m: m.RandCrop((96, 160)), lambda m: m.RandCropIncludeOOD((96, 160))):
        want = make(jt)(np.random.default_rng(4), jt.Sample(*_sample(4)))
        got = make(pt)(np.random.default_rng(4), pt.Sample(*_sample(4)))
        _assert_samples((got.image, got.mask, got.gen_image, got.gen_mask),
                        (want.image, want.mask, want.gen_image, want.gen_mask))


def test_crop_include_ood_without_anomaly_falls_back():
    want = jt.RandCropIncludeOOD((48, 96))(np.random.default_rng(5),
                                           jt.Sample(*_sample(5, ood=False)))
    got = pt.RandCropIncludeOOD((48, 96))(np.random.default_rng(5),
                                          pt.Sample(*_sample(5, ood=False)))
    _assert_samples((got.image, got.mask), (want.image, want.mask))


@pytest.mark.parametrize("name", ["ColorJitter", "Equalize"])
@pytest.mark.usefixtures("opencv_pin")
def test_colour_transforms_over_every_colour(name, every_colour):
    """ColorJitter (all four operations, in a drawn order) and Equalize on an
    image that holds every RGB colour."""
    x = every_colour.astype(np.float32) / 255.0
    want = TRANSFORMS[name](jt)(np.random.default_rng(7), jt.Sample(x.copy(), None))
    got = TRANSFORMS[name](pt)(np.random.default_rng(7), pt.Sample(x.copy(), None))
    np.testing.assert_allclose(got.image, want.image, rtol=0, atol=IMG_ATOL)


# ---------------------------------------------------------------- anomaly mix


def _coco_cut(seed, h=60, w=80):
    g = np.random.default_rng(seed)
    img = g.integers(0, 256, (h, w, 3)).astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    mask[10:40, 15:50] = 254
    mask[12:20, 20:30] = 255
    return img, mask


@pytest.mark.usefixtures("opencv_pin")
def test_random_scale_matches_jax():
    img, mask = _coco_cut(0)
    scales = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]
    for seed in range(6):
        want = jax_mix.random_scale(img, mask, scales, np.random.default_rng(seed))
        got = anomaly_mix.random_scale(img, mask, scales, np.random.default_rng(seed))
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=255 * IMG_ATOL)
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.usefixtures("opencv_pin")
def test_mix_object_matches_jax(normalized):
    cut_img, cut_mask = _coco_cut(1)
    for seed in range(3):
        img, mask, _, _ = _sample(seed)
        want = jax_mix.mix_object(img.copy(), mask.copy(), cut_img, cut_mask,
                                  np.random.default_rng(seed), normalized=normalized)
        got = anomaly_mix.mix_object(img.copy(), mask.copy(), cut_img, cut_mask,
                                     np.random.default_rng(seed), normalized=normalized)
        _assert_samples(got, want, atol=NORM_ATOL)
        assert (got[1] == 254).any()


def test_mixup_generated_matches_jax():
    g = np.random.default_rng(2)
    a, b = (g.integers(0, 256, (50, 70, 3)).astype(np.uint8) for _ in range(2))
    for seed in range(4):
        np.testing.assert_array_equal(
            anomaly_mix.mixup_generated(a, b, np.random.default_rng(seed)),
            jax_mix.mixup_generated(a, b, np.random.default_rng(seed)))


# ---------------------------------------------------------------- dataset


@pytest.fixture(scope="module")
def city_tree(tmp_path_factory):
    """A synthetic Cityscapes train split (two cities, 3 frames each of
    160x256 with labelTrainIds), two generated variants of most frames (one
    frame has none), and a 3-image COCO cut-out bank."""
    root = tmp_path_factory.mktemp("city")
    g = np.random.default_rng(0)

    def save(path, arr):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr).save(path)

    h, w = 160, 256
    for city in ("aachen", "bremen"):
        for i in range(3):
            stem = f"{city}_{i:06d}_000019"
            save(root / "cityscapes/leftImg8bit/train" / city / f"{stem}_leftImg8bit.png",
                 g.integers(0, 256, (h, w, 3)).astype(np.uint8))
            save(root / "cityscapes/gtFine/train" / city / f"{stem}_gtFine_labelTrainIds.png",
                 g.integers(0, 19, (h, w)).astype(np.uint8))
            if city == "bremen" and i == 1:
                continue  # a frame without a generated match is skipped
            for v in ("ade1", "ade2"):
                gstem = f"{stem}_{v}"
                save(root / "gen/leftImg8bit/train" / city / f"{gstem}_leftImg8bit.png",
                     g.integers(0, 256, (h, w, 3)).astype(np.uint8))
                lab = g.integers(0, 19, (h, w)).astype(np.uint8)
                lab[40:90, 60:140] = 254
                save(root / "gen/gtFine/train" / city / f"{gstem}_gtFine_labelTrainIds.png", lab)
    for i in range(3):
        save(root / "coco/train2017" / f"{i:012d}.jpg",
             g.integers(0, 256, (90, 120, 3)).astype(np.uint8))
        m = np.zeros((90, 120), np.uint8)
        m[20:60, 30:80] = 254
        save(root / "coco/annotations/oodclass_nocrowd_seg_train2017" / f"mask_{i:012d}.png", m)
    return {"root": str(root / "cityscapes"), "generation_root": str(root / "gen"),
            "coco_root": str(root / "coco")}


def _recipes(m):
    m2f = m.Compose([
        [m.ToTensor(), 1.0], [m.ColorJitter(), 0.5], [m.GaussianBlur(), 0.5],
        [m.RandSharpness(), 0.5], [m.AutoContrast(), 0.5], [m.Equalize(), 0.5],
        [m.RandResize(scale=[0.7, 0.8, 0.9, 1.0]), 0.5], [m.RandRotate(), 0.5],
        [m.RandHorizontalFlip(), 0.5], [m.RandVerticalFlip(), 0.5],
        [m.RandCrop(size=(96, 128)), 1.0], [m.Normalize(mean=MEAN, std=STD), 1.0]])
    deeplab = m.Compose([m.RandCrop(size=(96, 128)), m.ToTensor(),
                         m.Normalize(mean=MEAN, std=STD)])
    return {"m2f": m2f, "deeplab": deeplab}


@pytest.mark.parametrize("recipe", ["m2f", "deeplab"])
@pytest.mark.usefixtures("opencv_pin")
def test_diverse_cityscapes_matches_jax(recipe, city_tree):
    """Same pairings, and the same items at two epochs and several indices
    (mixup, the recipe's Compose, then the COCO paste)."""
    kw = dict(split="train", anomaly_mix=True, mixup=True, seed=3, **city_tree)
    want_ds = JaxDiverseCityscapes(transform=_recipes(jt)[recipe], **kw)
    got_ds = DiverseCityscapes(transform=_recipes(pt)[recipe], **kw)
    assert len(got_ds) == len(want_ds) == 5
    for attr in ("images", "targets", "generated_images", "generated_targets",
                 "coco_images", "coco_targets"):
        assert getattr(got_ds, attr) == getattr(want_ds, attr), attr
    for epoch in (0, 3):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        for i in (0, 2, 4):
            _assert_samples(got_ds[i], want_ds[i], atol=NORM_ATOL)


def test_label_table_matches_jax():
    from multishiftseg_tpu.data import cityscapes as jc
    from multishiftseg_torch.data import cityscapes as pc

    assert pc.LABELS == jc.LABELS and pc.NUM_TRAIN_IDS == jc.NUM_TRAIN_IDS
    np.testing.assert_array_equal(ID_TO_TRAIN_ID, jc.ID_TO_TRAIN_ID)


# ---------------------------------------------------------------- loader


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        g = np.random.default_rng(i)
        return g.random((4, 5, 3), dtype=np.float32), np.full((4, 5), i, np.int32), f"s{i}"


@pytest.mark.parametrize("shard_count", [1, 2])
def test_loader_batches_match_jax(shard_count):
    """Three epochs of batches from each shard: equal arrays and names."""
    ds = _Items(23)
    for shard in range(shard_count):
        want = JaxLoader(ds, batch_size=3, num_workers=3, seed=5, shard_index=shard,
                         shard_count=shard_count)
        got = Loader(ds, batch_size=3, num_workers=3, seed=5, shard_index=shard,
                     shard_count=shard_count)
        assert len(got) == len(want)
        for _ in range(3):
            w_batches, g_batches = list(want), list(got)
            assert len(g_batches) == len(w_batches) == len(want)
            for gb, wb in zip(g_batches, w_batches):
                np.testing.assert_array_equal(gb[0], wb[0])
                np.testing.assert_array_equal(gb[1], wb[1])
                assert gb[2] == wb[2]


def test_loader_cpu_device_gives_tensors_and_refuses_partial_shards():
    import torch

    (img, lab, names), = list(Loader(_Items(3), batch_size=3, device="cpu"))
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    assert tuple(img.shape) == (3, 4, 5, 3) and lab.dtype == torch.int32
    with pytest.raises(ValueError):
        Loader(_Items(3), batch_size=1, drop_last=False, shard_count=2)


def test_loader_raises_a_worker_exception_and_stops_early():
    class Broken(_Items):
        def __getitem__(self, i):
            if i == 4:
                raise KeyError("broken sample")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="broken sample"):
        list(Loader(Broken(8), batch_size=2, shuffle=False))
    loader = Loader(_Items(40), batch_size=2, prefetch=1)
    for _ in loader:
        break  # the producer ends on the consumer's stop
    assert len(list(loader)) == 20


# ---------------------------------------------------------------- decoding


def test_native_decode_matches_pil(tmp_path):
    g = np.random.default_rng(0)
    rgb = Image.fromarray(g.integers(0, 256, (31, 45, 3)).astype(np.uint8))
    gray = Image.fromarray(g.integers(0, 256, (31, 45)).astype(np.uint8))
    pal = gray.convert("P")
    paths = []
    for name, im in (("rgb", rgb), ("gray", gray), ("pal", pal)):
        paths.append(str(tmp_path / f"{name}.png"))
        im.save(paths[-1])
    want = [np.asarray(Image.open(p)) for p in paths]
    for got in ([native_io.decode(p) for p in paths], native_io.decode_batch(paths)):
        for a, b in zip(got, want):
            assert a.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
    assert native_io.decoder() in ("native", "pil")
    crop = native_io.normalize_crop(np.asarray(rgb), 3, 5, 10, 20, MEAN, STD)
    ref = (np.asarray(rgb)[3:13, 5:25].astype(np.float32) / 255 - np.float32(MEAN)) / np.float32(STD)
    np.testing.assert_allclose(crop, ref, rtol=0, atol=NORM_ATOL)
    assert os.path.isfile(str(native_io.SOURCE))
