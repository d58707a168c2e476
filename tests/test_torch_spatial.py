"""PyTorch port, the row-partitioned eval (``core/spatial.py``, the evaluator's
``--spatial``) against the JAX package's unsharded forwards, on the CPU.

Every slab sits on ``cpu`` (``slab_devices``). The tiny DeepLab of
``tests/test_mesh.py`` (128x128, :131-157) and the tiny Mask2Former
(:159-190) at N = 2 and 4 slabs against JAX's unsharded eval forward and
``inference`` at ``test_mesh.py``'s tolerances (DeepLab rtol 1e-4 / atol 1e-3,
M2F 2e-4), the M2F one in both approximate anomaly tails; an approximate
sample mode against the port's unsplit forward (its rounding decisions are
the port's own: JAX's differ in the last bit, ``test_torch_evaluator.py``);
the windowed score tail's plain version against the whole call's rows; and
the helpers: ``spatial_bucket_multiple`` equal to JAX's, the divisibility
error, the CLI's refusal of more slabs than cards.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multishiftseg_tpu.models.deeplab import DeepWV3Plus as JaxDeepLab
from multishiftseg_tpu.models.maskformer import MaskFormer as JaxMaskFormer
from multishiftseg_tpu.models.maskformer import inference as jax_inference
from multishiftseg_tpu.train import test_runner as jax_runner

from multishiftseg_torch.convert.from_jax import deeplab_from_jax, maskformer_from_jax
from multishiftseg_torch.core import spatial
from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models.deeplab import DeepWV3Plus
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.ops import scores
from multishiftseg_torch.train import test_runner
from multishiftseg_torch.train.m2f_trainer import eval_forward

from test_torch_swin import seeded_variables

DL_TINY = dict(trunk_structure=(1, 1, 1, 1, 1, 1),
               trunk_channels=((16, 16), (16, 16), (32, 32), (32, 32), (16, 32, 64),
                               (32, 64, 128)))
M2F_TINY = dict(num_classes=19, hidden_dim=32, num_queries=8, nheads=4, dim_feedforward=64,
                dec_layers=3, mask_dim=32, transformer_enc_layers=1)
HW = (128, 128)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the models are tiny, and the lane runs several
    test processes on the same cores, where more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("devices", [0, 1, 2, 3, 4, 6, 8])
def test_bucket_multiple_matches_jax(devices):
    for stride in (8, 16, 32):
        for base in (32, 64, 128, 256):
            assert (spatial.spatial_bucket_multiple(devices, stride, base)
                    == jax_runner.spatial_bucket_multiple(devices, stride, base))


def test_divisibility_error_and_card_refusal():
    """JAX's message where the height does not split into N x the deepest
    stride; the CLI refuses N above the cards present, before it builds
    anything; a slab list of the wrong length raises."""
    with pytest.raises(ValueError, match="not divisible by 32 .= 4 spatial devices x deepest "
                                         "stride 8"):
        spatial.check_height(136, 4, spatial.DEEPLAB_STRIDE)
    spatial.check_height(128, 4, spatial.DEEPLAB_STRIDE)
    with pytest.raises(ValueError, match="needs 2 cards; 0 are present"):
        test_runner.main(["--model", "deeplab", "--spatial", "2"])
    with pytest.raises(ValueError, match="3 slabs but 2 devices"):
        spatial.slab_devices(3, ["cpu", "cpu"])


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("rows", [(0, 24), (24, 40), (100, 28)])
def test_windowed_tail_plain_matches_whole_rows(mode, rows):
    """The tail's plain version over a window of output rows equals the rows of
    the whole call, in each mode (anomaly, semantic, classes)."""
    rng = np.random.RandomState(sum(rows) + mode)
    masks = torch.from_numpy(rng.randn(2, 6, 32, 48).astype(np.float32))
    probs = torch.softmax(torch.from_numpy(rng.randn(2, 6, 19).astype(np.float32)), -1)
    keep = torch.from_numpy(rng.rand(2, 6).astype(np.float32)) if mode == 1 else None
    whole = torch.ops.mss.mask_scores(masks, probs, keep, [128, 192], mode)
    part = torch.ops.mss.mask_scores(masks, probs, keep, [128, 192], mode, *rows)
    assert part.shape[-2:] == (rows[1], 192)
    np.testing.assert_allclose(part.numpy(), whole[..., rows[0]:rows[0] + rows[1], :].numpy(),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="outside a map of 128 rows"):
        scores._tail_plain(masks, probs, keep, [128, 192], mode, 120, 16)


# ---------------------------------------------------------------------------
# DeepLab


@pytest.fixture(scope="module")
def deeplab_run():
    jm = JaxDeepLab(num_classes=19, **DL_TINY)
    variables = seeded_variables(jm, 11, jnp.zeros((1, *HW, 3)), train=False)
    x = np.random.RandomState(0).randn(1, *HW, 3).astype(np.float32)
    score, logit = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    return dict(x=x, score=np.asarray(score), logit=np.asarray(logit).transpose(0, 3, 1, 2),
                state=deeplab_from_jax(variables))


@pytest.mark.parametrize("n", [2, 4])
def test_deeplab_slabs_match_jax(deeplab_run, n):
    """At N = 4 a slab holds 4 rows of the stride-8 map, so the rate-12 to
    rate-36 ASPP branches read halo rows from up to three slabs away."""
    cfg = load_config("exps/deeplab.yaml")
    cfg.train.bf16 = False
    model = DeepWV3Plus(**DL_TINY)
    model.load_state_dict(deeplab_run["state"], strict=True)
    fwd = test_runner.build_deeplab_forward(cfg, model=model, device="cpu",
                                            spatial_devices=n)
    score, logit = fwd(torch.from_numpy(deeplab_run["x"]))
    assert score.shape == (1, *HW) and logit.shape == (1, 19, *HW)
    np.testing.assert_allclose(score.numpy(), deeplab_run["score"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(logit.numpy(), deeplab_run["logit"], rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# Mask2Former


TAILS = {"exact": dict(), "lowres": dict(score_lowres=True), "topq": dict(score_topq=4)}


@pytest.fixture(scope="module")
def m2f_run():
    jm = JaxMaskFormer(**M2F_TINY)
    variables = seeded_variables(jm, 12, jnp.zeros((1, *HW, 3)), train=False)
    x = np.random.RandomState(1).randn(1, *HW, 3).astype(np.float32)
    outputs = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    ref = {}
    for name, kw in TAILS.items():
        sem, anomaly = jax_inference(outputs, HW, num_classes=19, **kw)
        ref[name] = (np.asarray(sem), np.asarray(anomaly))
    return dict(x=x, ref=ref, state=maskformer_from_jax(variables))


def m2f_forward(run, n, **kw):
    cfg = load_config("exps/m2f.yaml")
    cfg.train.bf16 = False
    model = MaskFormer(**M2F_TINY)
    model.load_state_dict(run["state"], strict=True)
    return test_runner.build_m2f_forward(cfg, model=model, device="cpu", spatial_devices=n,
                                         enforce_qualification=False, **kw), model


@pytest.mark.parametrize("n,tail", [(2, "exact"), (4, "exact"), (2, "lowres"), (4, "topq")])
def test_m2f_slabs_match_jax(m2f_run, n, tail):
    """The backbone and pixel decoder slab by slab (halo rows, the slab
    GroupNorms, the encoder's queries over the gathered table), the decoder
    whole, the tails' row windows: JAX's unsharded ``inference`` within 2e-4,
    in the exact tail and both approximate ones."""
    fwd, _ = m2f_forward(m2f_run, n, **TAILS[tail])
    anomaly, sem = fwd(torch.from_numpy(m2f_run["x"]))
    sem_ref, anomaly_ref = m2f_run["ref"][tail]
    assert sem.shape == sem_ref.shape and anomaly.shape == anomaly_ref.shape
    np.testing.assert_allclose(anomaly.numpy(), anomaly_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sem.numpy(), sem_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["nearest"])
def test_m2f_slabs_approximate_modes_match_unsplit(m2f_run, mode):
    """An approximate sample mode over 2 slabs: every slab's queries sample the
    whole gathered table, so the result is the port's unsplit forward's."""
    fwd, model = m2f_forward(m2f_run, 2, sample_mode=mode)
    anomaly, sem = fwd(torch.from_numpy(m2f_run["x"]))
    sem_ref, anomaly_ref = eval_forward(model, torch.from_numpy(m2f_run["x"]),
                                        sample_mode=mode)
    np.testing.assert_allclose(anomaly.numpy(), anomaly_ref.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sem.numpy(), sem_ref.numpy(), rtol=2e-4, atol=2e-4)
