"""PyTorch port, the binned OOD metrics and per-epoch validation against the JAX
package on the CPU.

``masked_min_max`` / ``label_histograms`` (the plain versions of ``csrc/ood_hist.cu``),
``BinnedOODMeter``, ``binned_ood_metrics`` and ``metrics_from_histograms``
against their JAX counterparts on the same maps: ranges and histograms exactly
equal, metrics within 1e-12 (float64 finish) or f32 rounding (on-device finish).
``batched_valid`` against JAX's with the same score function (exact), and both
trainers' ``valid`` with a tiny model in each framework (within 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multishiftseg_tpu.core.config import load_config as jax_load_config
from multishiftseg_tpu.evals import ood_metrics as jax_om
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.train.m2f_trainer import TrainM2FOOD as JaxTrainM2FOOD
from multishiftseg_tpu.train.state import TrainState
from multishiftseg_tpu.train.validation import batched_valid as jax_batched_valid

from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.evals import ood_metrics as om
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.train.deeplab_trainer import TrainDeepLabOOD
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD
from multishiftseg_torch.train.validation import batched_valid

from test_torch_deeplab import TINY, tiny_variables

NB = 8192


def _maps(seed, shapes=((40, 60), (33, 47), (64, 32))):
    """Score maps with labels 0 / 1 / 255: OOD scores drawn higher."""
    rng = np.random.RandomState(seed)
    out = []
    for h, w in shapes:
        labels = rng.choice([0, 1, 255], size=(h, w), p=[0.6, 0.25, 0.15]).astype(np.int32)
        scores = (0.7 * rng.rand(h, w) + 0.3 * (labels == 1) * rng.rand(h, w)).astype(np.float32)
        out.append((scores, labels))
    return out


def _edge_maps():
    """No valid pixel; one class only; constant scores; a NaN score."""
    rng = np.random.RandomState(9)
    void = (rng.rand(8, 8).astype(np.float32), np.full((8, 8), 255, np.int32))
    in_only = (rng.rand(8, 8).astype(np.float32), np.zeros((8, 8), np.int32))
    const = (np.full((8, 8), 0.25, np.float32), rng.randint(0, 2, (8, 8)).astype(np.int32))
    nan = (rng.rand(8, 8).astype(np.float32), rng.randint(0, 2, (8, 8)).astype(np.int32))
    nan[0][3, 4] = np.nan
    return void, in_only, const, nan


EDGE_CASES = ("void", "in_only", "const", "nan")


@pytest.mark.parametrize("case", ("maps",) + EDGE_CASES)
def test_min_max_and_histogram_equal_jax(case):
    """The range (NaN where a valid score is NaN, as JAX's) and the
    histograms from zero, exactly."""
    maps = _maps(0) if case == "maps" else [dict(zip(EDGE_CASES, _edge_maps()))[case]]
    for scores, labels in maps:
        lo, hi = om.masked_min_max(torch.from_numpy(scores), torch.from_numpy(labels))
        lo_j, hi_j = jax_om._masked_min_max(jnp.asarray(scores), jnp.asarray(labels))
        np.testing.assert_array_equal([float(lo), float(hi)], [float(lo_j), float(hi_j)])
        if case == "nan":
            assert np.isnan(float(lo)) and np.isnan(float(hi))
            continue
        pos, neg = om.label_histograms(torch.from_numpy(scores), torch.from_numpy(labels),
                                       lo, hi, NB)
        zj = jnp.zeros(NB, jnp.int32)
        pos_j, neg_j = jax_om._hist_update(zj, zj, jnp.asarray(scores), jnp.asarray(labels),
                                           lo_j, hi_j, NB)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(neg_j))
        assert int(pos.sum()) == int((labels == 1).sum())
        assert int(neg.sum()) == int((labels == 0).sum())


@pytest.mark.parametrize("case", ["maps", "with_edge_maps", "one_class_only"])
def test_binned_meter_matches_jax(case):
    maps = {"maps": _maps(1), "with_edge_maps": _maps(2) + list(_edge_maps()),
            "one_class_only": [_edge_maps()[1]]}[case]
    ours, ref = om.BinnedOODMeter(), jax_om.BinnedOODMeter()
    for scores, labels in maps:
        ours.update(torch.from_numpy(scores), labels)
        ref.update(jnp.asarray(scores), labels)
    assert len(ours._hists) == len(ref._hists)
    for (p, n, lo, hi), (pj, nj, loj, hij) in zip(ours._hists, ref._hists):
        np.testing.assert_array_equal(p, pj)
        np.testing.assert_array_equal(n, nj)
        assert (lo, hi) == (loj, hij)
    got, want = ours.compute(), ref.compute()
    if case == "one_class_only":
        assert got is None and want is None
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_binned_metrics_match_jax_and_the_exact_ones():
    """``binned_ood_metrics`` and ``metrics_from_histograms`` against JAX (f32
    finish on the tensors' device: f32 rounding), and the binned metrics, one
    map and the meter over many, within 2 / 8192 of the exact ones."""
    maps = _maps(3, shapes=((200, 300), (150, 256), (256, 128)))
    scores = np.concatenate([s.reshape(-1) for s, _ in maps])
    labels = np.concatenate([lb.reshape(-1) for _, lb in maps])
    got = om.binned_ood_metrics(torch.from_numpy(scores), torch.from_numpy(labels))
    want = jax_om.binned_ood_metrics(jnp.asarray(scores), jnp.asarray(labels))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                               rtol=0, atol=1e-6)
    for lo, hi in ((0.1, 0.9), (-1.0, 2.0)):  # a given range, pixels outside it
        got = om.binned_ood_metrics(torch.from_numpy(scores), torch.from_numpy(labels),
                                    lo=lo, hi=hi)
        want = jax_om.binned_ood_metrics(jnp.asarray(scores), jnp.asarray(labels), lo=lo, hi=hi)
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                                   rtol=0, atol=1e-6)
    rng = np.random.RandomState(4)
    pos, neg = rng.randint(0, 50, NB), rng.randint(0, 50, NB)
    got = om.metrics_from_histograms(torch.from_numpy(pos), torch.from_numpy(neg))
    want = jax_om.metrics_from_histograms(jnp.asarray(pos), jnp.asarray(neg))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                               rtol=0, atol=1e-6)

    exact = om.eval_ood_measure(scores, labels)
    meter = om.BinnedOODMeter()
    for s, lb in maps:
        meter.update(torch.from_numpy(s), lb)
    one_map = [float(v) for v in om.binned_ood_metrics(torch.from_numpy(scores),
                                                        torch.from_numpy(labels))]
    for binned in (one_map, meter.compute()):
        np.testing.assert_allclose(binned, exact, rtol=0, atol=2 / NB)


def _bad_score_map(value, where, seed=10, n=1000):
    """1000 scores in [0, 1) with labels 0 / 1 / 255, one of them ``value``
    (NaN, +inf or -inf) at a valid pixel or at a void one."""
    rng = np.random.RandomState(seed)
    scores = rng.rand(n).astype(np.float32)
    labels = rng.choice([0, 1, 255], size=n, p=[0.6, 0.25, 0.15]).astype(np.int32)
    i = int(np.flatnonzero(labels != 255 if where == "valid" else labels == 255)[7])
    scores[i] = value
    return scores, labels


NON_FINITE = {"nan": np.nan, "pos_inf": np.inf, "neg_inf": -np.inf}


@pytest.mark.parametrize("given", [None, (0.0, 1.0)], ids=["own_range", "given_range"])
@pytest.mark.parametrize("where", ["valid", "void"])
@pytest.mark.parametrize("value", sorted(NON_FINITE))
def test_non_finite_scores_match_jax(value, where, given):
    """A NaN or infinite score, in a valid pixel or a void one, over the map's
    own range or a given one: the histograms equal JAX's (a NaN bin, from a
    NaN score or an infinite range, is bin 0) and ``binned_ood_metrics``
    matches JAX's within f32 rounding."""
    scores, labels = _bad_score_map(NON_FINITE[value], where)
    st, lt = torch.from_numpy(scores), torch.from_numpy(labels)
    if given is None:
        lo, hi = om.masked_min_max(st, lt)
        lo_j, hi_j = jax_om._masked_min_max(jnp.asarray(scores), jnp.asarray(labels))
        np.testing.assert_array_equal([float(lo), float(hi)], [float(lo_j), float(hi_j)])
    else:
        lo, hi = lo_j, hi_j = given
    for nb in (64, NB):
        pos, neg = om.label_histograms(st, lt, lo, hi, nb)
        zj = jnp.zeros(nb, jnp.int32)
        pos_j, neg_j = jax_om._hist_update(zj, zj, jnp.asarray(scores), jnp.asarray(labels),
                                           jnp.float32(lo_j), jnp.float32(hi_j), nb)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
        np.testing.assert_array_equal(neg.numpy(), np.asarray(neg_j))
        kw = {} if given is None else dict(lo=given[0], hi=given[1])
        got = om.binned_ood_metrics(st, lt, num_bins=nb, **kw)
        want = jax_om.binned_ood_metrics(jnp.asarray(scores), jnp.asarray(labels),
                                         num_bins=nb, **kw)
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ("maps",) + EDGE_CASES + tuple(sorted(NON_FINITE)))
def test_range_histograms_equal_the_plain_sequence(case):
    """``range_histograms`` on the CPU is ``masked_min_max`` then
    ``label_histograms`` over that range, exactly (NaN ranges included)."""
    if case in NON_FINITE:
        maps = [_bad_score_map(NON_FINITE[case], "valid")]
    else:
        maps = _maps(11) if case == "maps" else [dict(zip(EDGE_CASES, _edge_maps()))[case]]
    for scores, labels in maps:
        st, lt = torch.from_numpy(scores), torch.from_numpy(labels)
        lo, hi, pos, neg = om.range_histograms(st, lt, NB)
        lo_p, hi_p = om.masked_min_max_plain(st, lt)
        pos_p, neg_p = om.label_histograms_plain(st, lt, lo_p, hi_p, NB)
        np.testing.assert_array_equal([float(lo), float(hi)], [float(lo_p), float(hi_p)])
        assert torch.equal(pos, pos_p) and torch.equal(neg, neg_p)
        assert pos.dtype == neg.dtype == torch.int32 and lo.dtype == torch.float32


@pytest.mark.parametrize("kind", ["numpy", "tensor_int32", "tensor_int64"])
def test_binned_meter_takes_labels_as_an_array_or_a_tensor(kind):
    """``update`` takes labels as a numpy array or as a tensor (here on the
    CPU; on the card, tests/test_torch_kernels.py): the same histograms as
    JAX's meter given the same labels."""
    ours, ref = om.BinnedOODMeter(), jax_om.BinnedOODMeter()
    for scores, labels in _maps(12):
        lab = {"numpy": labels, "tensor_int32": torch.from_numpy(labels),
               "tensor_int64": torch.from_numpy(labels.astype(np.int64))}[kind]
        ours.update(torch.from_numpy(scores), lab)
        ref.update(jnp.asarray(scores), labels)
    for (p, n, lo, hi), (pj, nj, loj, hij) in zip(ours._hists, ref._hists):
        np.testing.assert_array_equal(p, pj)
        np.testing.assert_array_equal(n, nj)
        assert (lo, hi) == (loj, hij)
    np.testing.assert_allclose(ours.compute(), ref.compute(), rtol=0, atol=1e-12)


class _InMemory:
    """A validation set without an ``images`` path list: (image, labels, name)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _val_set(seed, shapes=((60, 100), (50, 70), (130, 90), (64, 128), (40, 40))):
    rng = np.random.RandomState(seed)
    items = []
    for i, (h, w) in enumerate(shapes):
        img = rng.randn(h, w, 3).astype(np.float32)
        lab = rng.choice([0, 1, 255], size=(h, w), p=[0.6, 0.3, 0.1]).astype(np.int32)
        items.append((img, lab, f"img{i}"))
    return _InMemory(items)


def test_batched_valid_matches_jax_with_the_same_score_function():
    """Five images in three buckets (two share one); the score is one channel
    minus another, exact in both frameworks."""
    ds = _val_set(5)
    got = batched_valid(ds, lambda imgs: imgs[..., 0] - imgs[..., 1])
    want = jax_batched_valid(ds, lambda imgs: imgs[..., 0] - imgs[..., 1])
    assert set(got) == {"AUROC", "AUPRC", "FPR_TPR95"}
    for k in want:
        assert got[k] == want[k], k
    assert batched_valid(_InMemory([]), lambda imgs: imgs[..., 0]) is None


def test_batched_valid_refuses_an_image_larger_than_its_bucket(tmp_path):
    """With an ``images`` path list the buckets come from the files' headers;
    an item larger than its file breaks the contract and is refused."""
    from PIL import Image

    path = str(tmp_path / "a.png")
    Image.fromarray(np.zeros((60, 100, 3), np.uint8)).save(path)

    class Growing(_InMemory):
        images = [path]

    big = (np.zeros((200, 100, 3), np.float32), np.zeros((200, 100), np.int32), "a")
    with pytest.raises(AssertionError, match="exceeds its shape bucket"):
        batched_valid(Growing([big]), lambda imgs: imgs[..., 0])


M2F = dict(num_classes=19, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
           dec_layers=3, mask_dim=32, transformer_enc_layers=1)


def test_m2f_valid_matches_jax_with_a_tiny_model():
    from test_torch_m2f_stage1 import _perturbed

    from multishiftseg_torch.convert.from_jax import maskformer_from_jax

    jcfg = jax_load_config("exps/m2f.yaml")
    jcfg.train.train_batch, jcfg.train.bf16, jcfg.data.crop_size = 1, False, (64, 64)
    jtr = JaxTrainM2FOOD(jcfg, model=JaxMaskFormer(**M2F))
    variables = _perturbed(jax.tree_util.tree_map(np.asarray, jtr.variables), 3)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=None, step=0, rng=None)
    ds = _val_set(7, shapes=((60, 100), (50, 70), (130, 90)))
    want = jtr.valid(state, ds, jtr.make_eval_step())
    cfg = load_config("exps/m2f.yaml")
    cfg.train.bf16 = False
    tr = TrainM2FOOD(cfg, model=MaskFormer(**M2F), device="cpu")
    tr.model.load_state_dict(maskformer_from_jax(variables), strict=True)
    got = tr.valid(ds)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
    # the eval step under it, both heads, on one padded batch
    imgs = np.zeros((2, 128, 128, 3), np.float32)
    imgs[:, :60, :100] = ds[0][0]
    sem_j, anomaly_j = jtr.make_eval_step()(variables, jnp.asarray(imgs))
    sem, anomaly = tr.eval_step(imgs)
    assert sem.shape == (2, 19 + 8, 128, 128) and anomaly.shape == (2, 128, 128)
    for a, b in ((sem, sem_j), (anomaly, anomaly_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)


def test_deeplab_valid_matches_jax_with_a_tiny_model():
    from multishiftseg_torch.convert.from_jax import deeplab_from_jax

    jm, variables = tiny_variables(seed=4)
    ds = _val_set(8, shapes=((64, 96), (40, 72), (140, 64)))
    want = jax_batched_valid(ds, jax.jit(lambda x: jm.apply(variables, x, train=False)[0]))
    cfg = load_config("exps/deeplab.yaml")
    cfg.train.bf16 = False
    tr = TrainDeepLabOOD(cfg, model=DeepWV3Plus(**TINY), device="cpu")
    tr.model.load_state_dict(deeplab_from_jax(variables), strict=True)
    got = tr.valid(ds)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])
