"""PyTorch port, the deformable encoder's rematerialisation in training
(``models/pixel_decoder.py``, JAX ``pixel_decoder.py:127-159``) on the CPU.

In training each ``DeformableEncoderLayer`` checkpoints the segments before
and after the deformable core; the core runs once and keeps its own saved
tensors, as JAX's ``save_only_these_names("deform_core")`` keeps the core's
output. Held here: the encoder's loss and gradients equal those of the same
layers without checkpoints, the core's forward runs once a layer a step (its
plain version's calls counted) while the two segments run twice, and the
whole stage-2 step equals the step without the remat. ``test_torch_train.py``
holds that step, remat on, to JAX's.
"""

import numpy as np
import pytest
import torch

from multishiftseg_torch.core.config import load_config
from multishiftseg_torch.models import pixel_decoder
from multishiftseg_torch.models.maskformer import MaskFormer
from multishiftseg_torch.ops import ms_deform_attn
from multishiftseg_torch.train.m2f_trainer import TrainM2FOOD, synthetic_batch

SHAPES = [(4, 6), (8, 12), (16, 24)]


def plain_layer(layer, src, pos, ref, shapes):
    """The layer's forward without checkpoints."""
    value, loc, attn = layer._sampling(src, pos, ref, shapes)
    return layer._finish(src, ms_deform_attn.ms_deform_attn_core(value, shapes, loc, attn))


def encoder_run(layers, remat: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    s = sum(h * w for h, w in SHAPES)
    src = torch.randn(2, s, 32, generator=g, requires_grad=True)
    pos = torch.randn(2, s, 32, generator=g)
    ref = torch.rand(2, s, len(SHAPES), 2, generator=g)
    x = src
    for layer in layers:
        x = layer(x, pos, ref, SHAPES) if remat else plain_layer(layer, x, pos, ref, SHAPES)
    loss = (x * torch.randn(x.shape, generator=g)).sum()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in layers.named_parameters()}
    grads["src"] = src.grad.clone()
    layers.zero_grad(set_to_none=True)
    return loss.detach(), grads


def test_encoder_remat_equals_the_plain_layers():
    """Loss and every gradient (parameters and input) within 1e-6 of scale."""
    torch.manual_seed(0)
    layers = torch.nn.ModuleList(pixel_decoder.DeformableEncoderLayer(
        d_model=32, d_ffn=64, n_levels=len(SHAPES), n_heads=4, n_points=2) for _ in range(2))
    for p in layers.parameters():  # offsets and weights off their zero init
        torch.nn.init.normal_(p, std=0.1)
    layers.train()
    loss_r, grads_r = encoder_run(layers, remat=True)
    loss_p, grads_p = encoder_run(layers, remat=False)
    assert abs(float(loss_r - loss_p)) <= 1e-6 * abs(float(loss_p))
    assert set(grads_r) == set(grads_p) and len(grads_p) == 2 * 16 + 1
    for name, want in grads_p.items():
        assert float((grads_r[name] - want).abs().max()) <= 1e-6 * float(want.abs().max()), name


def tiny_trainer():
    cfg = load_config("exps/m2f.yaml")
    cfg.data.crop_size, cfg.model.m2f.train_num_points, cfg.train.bf16 = (60, 60), 64, False
    cfg.loss.params["num_pair_samples"] = 256
    torch.manual_seed(0)
    tr = TrainM2FOOD(cfg, model=MaskFormer(hidden_dim=64, num_queries=20, nheads=4,
                                           dim_feedforward=128, dec_layers=3, mask_dim=64,
                                           transformer_enc_layers=2), device="cpu")
    tr.set_stage(1)
    return tr


def counted(monkeypatch, owner, name, counts):
    fn = getattr(owner, name)

    def wrapped(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(owner, name, wrapped)


@pytest.fixture(scope="module")
def stage2_steps():
    """One stage-2 step with the remat and one with the encoder layers
    unchecked (each layer's ``_segment`` replaced by a direct call), from the
    same weights, batch and draws, counting the core's and the segments'
    calls."""
    batch = synthetic_batch(1, (60, 60), 19, seed=0)
    runs = {}
    for remat in (True, False):
        tr = tiny_trainer()
        draws = tr.draws(2, (64, 64))
        counts = {}
        with pytest.MonkeyPatch.context() as mp:
            counted(mp, ms_deform_attn, "ms_deform_attn_core_plain", counts)
            counted(mp, pixel_decoder.DeformableEncoderLayer, "_sampling", counts)
            counted(mp, pixel_decoder.DeformableEncoderLayer, "_finish", counts)
            if not remat:
                mp.setattr(pixel_decoder.DeformableEncoderLayer, "_segment",
                           lambda self, remat, fn, *args: fn(*args))
            loss, losses, grad_norm, _ = tr.stage2_step(*batch, draws=draws)
        runs[remat] = dict(loss=float(loss), grad_norm=float(grad_norm), counts=counts,
                           params={n: p.detach().clone() for n, p in tr.model.named_parameters()},
                           grads={n: p.grad.clone() for n, p in tr.model.named_parameters()})
    return runs


def test_core_runs_once_a_layer_and_the_segments_recompute(stage2_steps):
    """Two encoder layers: the core's forward twice a step (no recompute), each
    checkpointed segment four times (forward and backward); without the remat
    each twice."""
    assert stage2_steps[True]["counts"] == {"ms_deform_attn_core_plain": 2, "_sampling": 4,
                                           "_finish": 4}
    assert stage2_steps[False]["counts"] == {"ms_deform_attn_core_plain": 2, "_sampling": 2,
                                            "_finish": 2}


def test_stage2_step_with_the_remat_equals_the_step_without(stage2_steps):
    """Loss, gradient norm, every gradient and every updated parameter within
    1e-6 of scale."""
    a, b = stage2_steps[True], stage2_steps[False]
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
    assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-6)
    for name, want in b["grads"].items():
        scale = max(float(want.abs().max()), 1e-30)
        assert float((a["grads"][name] - want).abs().max()) <= 1e-6 * scale, name
        np.testing.assert_allclose(a["params"][name].numpy(), b["params"][name].numpy(),
                                   rtol=0, atol=1e-6 * float(b["params"][name].abs().max()))
