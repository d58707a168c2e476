"""PyTorch port, the generic DeepLab v3+ (``models/deepv3_generic.py``) against
the JAX package on the CPU: ``DeepV3Plus`` on its four trunks (ResNet-50 / 101,
SEResNeXt-50 / 101) at full widths, from seeded numpy weights in the JAX
init's shapes (``test_torch_swin.seeded_variables``) through ``deepv3_from_jax``.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from multishiftseg_tpu.models.deepv3_generic import DeepV3Plus as JaxDeepV3Plus

from multishiftseg_torch.convert.from_jax import deepv3_from_jax
from multishiftseg_torch.models.deepv3_generic import DeepV3Plus

from test_torch_swin import rel_err, seeded_variables


@pytest.mark.parametrize("trunk,train,shape", [
    ("resnet-50", True, (4, 32, 32)), ("seresnext-50", False, (4, 32, 32)),
    ("resnet-101", False, (4, 32, 32)), ("seresnext-101", False, (4, 32, 32)),
    ("resnet-50", False, (1, 112, 224))])
def test_deepv3plus_matches_jax(trunk, train, shape):
    """Eval logits within 1e-4 of scale. On 4 images of 32x32 (a 4x4 map at
    output stride 8) every trunk, the ASPP's dilated 3x3 convs taking 2048
    channels on all four; there the dilated taps fall outside the map but the
    centre. On one 112x224 image (a 14x28 map) res5's dilation-4 taps and the
    ASPP's rate-12 and rate-24 taps land in the map, so the dilations are held
    too. On ResNet-50 also the train-mode forward (batch statistics in every
    BatchNorm, the trunk's included) and its updated running statistics: the
    port's f32 within 1e-4 of its float64 run, and JAX's f32 within 3e-3 of
    that float64 run. flax takes each batch variance in one pass, E[x^2] -
    E[x]^2 in f32, and over about 60 train-mode BatchNorms (and the
    image-pooling branch's statistics over the batch's 4 values) that rounding
    grows to about 1e-3 of scale. SEResNeXt's BatchNorms are the same module
    (``layers.BatchNorm2d``) and the 101-layer trunks differ from the 50-layer
    ones only in their stage tables."""
    img = np.random.RandomState(3).randn(*shape, 3).astype(np.float32)
    jm = JaxDeepV3Plus(trunk=trunk)
    variables = seeded_variables(jm, 4, jnp.asarray(img[:1]))
    # each residual branch's last BatchNorm at scale 0.2: a random deep trunk
    # at unit scales amplifies f32 rounding from layer to layer
    flat = flax.traverse_util.flatten_dict(variables)
    for k in flat:
        if k[-1] == "scale" and ("norm3" in k or "bn3" in k):
            flat[k] = 0.2 * flat[k]
    variables = flax.traverse_util.unflatten_dict(flat)

    @jax.jit
    def run(v, x):
        if not train:
            return jm.apply(v, x, train=False), None, None
        out, state = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x, train=False), out, state["batch_stats"]

    ref_eval, ref_train, ref_stats = run(variables, jnp.asarray(img))
    runs = {}
    for dtype in (torch.float32, torch.float64) if train else (torch.float32,):
        port = DeepV3Plus(trunk=trunk)
        port.load_state_dict(deepv3_from_jax(variables), strict=True)
        port.to(dtype)
        x = torch.from_numpy(img).permute(0, 3, 1, 2).to(dtype)
        with torch.no_grad():
            runs[dtype] = (port.eval()(x), port.train()(x) if train else None,
                           dict(port.named_buffers()))
    assert port.aspp.features[1][0].weight.shape[1] == 2048
    ev = runs[torch.float32][0]
    assert tuple(ev.shape) == (shape[0], 19, *shape[1:]) and ev.dtype == torch.float32
    assert rel_err(ev.numpy(), np.asarray(ref_eval).transpose(0, 3, 1, 2)) < 1e-4
    if not train:
        return
    (_, tr, buf), (_, tr64, buf64) = runs[torch.float32], runs[torch.float64]
    assert rel_err(tr.numpy(), tr64.numpy()) < 1e-4
    assert rel_err(np.asarray(ref_train).transpose(0, 3, 1, 2), tr64.numpy()) < 3e-3
    ref_stats = deepv3_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray, ref_stats)})
    assert set(ref_stats) == set(buf)
    for k, want in ref_stats.items():
        assert rel_err(buf[k].numpy(), buf64[k].numpy()) < 1e-4, k
        assert rel_err(want.numpy(), buf64[k].numpy()) < 3e-3, k
