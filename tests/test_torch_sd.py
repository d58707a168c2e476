"""PyTorch port, ControlNet-SD1.5 (``multishiftseg_torch/cgaug/{clip_text,sd_unet,
sd_vae,sd_pipeline}.py``) against the JAX package's towers, on the CPU.

The port's towers at tiny widths get numpy-seeded weights
(:func:`seeded_state_dict`); the JAX towers get the same tensors through the
JAX package's own checkpoint converter (``convert_control_sd15``), so the port's
module tree is held to the checkpoint's names too. Inputs are numpy draws.
Tolerances: f32 module outputs within 1e-5 of the output's largest magnitude;
the 4-step guided sampler and the decoded floats within 1e-4 (guidance 9.0
amplifies each step's eps difference; those two tests are in
``test_torch_cgaug_generate.py``, which shares their compiled JAX sampler);
the tokenizer's ids exactly. At full
width the towers are built on the ``meta`` device: their parameter counts
equal ``jax.eval_shape`` of the JAX inits, and ``control_sd15_from_jax``
inverts the converter exactly.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multishiftseg_tpu.cgaug import clip_text as jclip
from multishiftseg_tpu.cgaug import sd_pipeline as jpipe
from multishiftseg_tpu.cgaug import sd_unet as junet
from multishiftseg_tpu.cgaug import sd_vae as jvae
from multishiftseg_tpu.convert.sd_controlnet import convert_control_sd15

from multishiftseg_torch.cgaug import clip_text, sd_pipeline, sd_unet, sd_vae
from multishiftseg_torch.convert.from_jax import control_sd15_from_jax

MODULE_RTOL = 1e-5   # of the output's largest magnitude, f32
SAMPLER_RTOL = 1e-4  # the guided sampler and the decoded image
VOCAB = 520          # the synthetic vocab of write_tiny_vocab
N_STEPS = 4  # the uniform subsequence of 3 steps indexes step 1000 of 1000 (JAX raises too)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the towers are tiny, and the lane runs several
    test processes on the same cores, where more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def seeded_state_dict(module: torch.nn.Module, seed: int):
    """``module``'s state dict drawn with numpy from ``seed``: weights of two or
    more axes normal over sqrt(fan in), 1-D weights (norm scales, biases of the
    tables aside) 1 + 0.1 noise, biases 0.1 noise; loaded into ``module``."""
    g = np.random.RandomState(seed)
    out = {}
    for k, t in module.state_dict().items():
        shape = tuple(t.shape)
        noise = g.randn(*shape)
        if k.endswith("bias"):
            v = 0.1 * noise
        elif len(shape) >= 2:
            v = noise / np.sqrt(np.prod(shape[1:]))
        else:
            v = 1 + 0.1 * noise
        out[k] = torch.from_numpy(np.asarray(v, np.float32))
    module.load_state_dict(out)
    return out


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def write_tiny_vocab(tmp_path):
    """A byte-level vocab with a few merges (``tests/test_sd_controlnet.py``'s)."""
    chars = sorted(clip_text.bytes_to_unicode().values())
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    for tok in ["ll", "he", "llo</w>", "hello</w>", "wo", "rld</w>",
                "<|startoftext|>", "<|endoftext|>"]:
        vocab[tok] = len(vocab)
    merges = ["#version: 0.2", "l l", "h e", "ll o</w>", "he llo</w>", "w o", "r ld</w>"]
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("\n".join(merges) + "\n")
    assert len(vocab) == VOCAB
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def tiny_cfgs():
    """(port, JAX) configs of the tiny towers: the UNet's context is the tiny
    CLIP's width, its transformers at the first level and the middle only
    (each one more costs JAX's compile seconds), and the VAE has SD's four
    levels (8x) at 32 channels, so an image comes out at its label's size."""
    port = (sd_unet.tiny_sd_config(attention_ds=(1,)),
            sd_vae.tiny_vae_config(ch_mult=(1, 1, 1, 1)),
            clip_text.tiny_clip_config(vocab_size=VOCAB, width=16))
    jax_cfgs = (junet.tiny_sd_config(attention_ds=(1,)),
                jvae.tiny_vae_config(ch_mult=(1, 1, 1, 1)),
                jclip.tiny_clip_config(vocab_size=VOCAB, width=16))
    return port, jax_cfgs


@pytest.fixture(scope="module")
def towers():
    """The port's tiny ControlLDM with seeded weights, and JAX's params from
    the same tensors through ``convert_control_sd15``."""
    (ucfg, vcfg, ccfg), (jucfg, jvcfg, jccfg) = tiny_cfgs()
    ldm = sd_pipeline.ControlLDM(ucfg, vcfg, ccfg).eval()
    sd = seeded_state_dict(ldm, 0)
    params = convert_control_sd15(sd, jucfg, jvcfg, jccfg)
    return ldm, params, (jucfg, jvcfg, jccfg)


def test_control_sd15_from_jax_round_trips_the_state_dict(towers):
    ldm, params, (jucfg, jvcfg, jccfg) = towers
    (ucfg, vcfg, ccfg), _ = tiny_cfgs()
    back = control_sd15_from_jax(params, ucfg, vcfg, ccfg)
    sd = ldm.state_dict()
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_full_width_towers_match_jax_parameter_counts():
    """SD1.5's UNet, ControlNet-v15, the VAE and CLIP-L's text tower, built on
    the meta device: each parameter count equals ``jax.eval_shape`` of the
    JAX tower's init, and the checkpoint's names convert both ways."""
    with torch.device("meta"):
        ldm = sd_pipeline.ControlLDM()
    x = jnp.zeros((1, 8, 8, 4))
    t = jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 77, 768))
    k = jax.random.PRNGKey(0)
    inits = {
        "unet": lambda: junet.SDUNet().init(k, x, t, ctx),
        "control": lambda: junet.ControlNetBranch().init(k, x, jnp.zeros((1, 64, 64, 3)), t, ctx),
        "vae": lambda: jvae.AutoencoderKL().init(k, jnp.zeros((1, 32, 32, 3))),
        "clip": lambda: jclip.CLIPTextEncoder().init(k, jnp.zeros((1, 77), jnp.int32)),
    }
    towers = {"unet": ldm.unet, "control": ldm.control_model, "vae": ldm.vae, "clip": ldm.clip}
    expected = {"unet": 859_520_964, "control": 361_279_120, "vae": 83_653_863,
                "clip": 123_060_480}
    shapes = {}
    for name, init in inits.items():
        tree = jax.eval_shape(init)["params"]
        shapes[name] = tree
        n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))
        n_port = sum(p.numel() for p in towers[name].parameters())
        assert n_port == n_jax == expected[name], name
    # every parameter of the port is named by the checkpoint layout the JAX
    # converter reads: the converter's output has the JAX init's structure
    sd = {k: np.broadcast_to(np.float32(0), v.shape) for k, v in ldm.state_dict().items()}
    conv = convert_control_sd15(sd)
    for name, tree in shapes.items():
        assert jax.tree.map(lambda a: tuple(a.shape), tree) == jax.tree.map(np.shape, conv[name])


@pytest.fixture(scope="module")
def inputs():
    g = np.random.RandomState(1)
    return {"x": g.randn(2, 8, 8, 4).astype(np.float32),
            "hint": g.rand(2, 64, 64, 3).astype(np.float32),
            "t": np.array([981, 21], np.int32),
            "ctx": g.randn(2, 77, 16).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_control(towers, inputs):
    _, params, (jucfg, _, _) = towers
    fn = jax.jit(lambda p, x, h, t, c: junet.ControlNetBranch(jucfg).apply(
        {"params": p}, x, h, t, c))
    return fn(params["control"], inputs["x"], inputs["hint"], inputs["t"], inputs["ctx"])


def test_timestep_embedding_matches_jax():
    """The frequency table's f32 ``exp`` may differ from XLA's by one ulp (both
    are one ulp from the exact value at some entries), and ``t`` up to 981
    multiplies that difference: each entry is held within what one ulp of its
    frequency moves it, plus two ulps of the cos / sin."""
    t = np.array([1, 21, 500, 981], np.int32)
    half = 160
    got = sd_unet.timestep_embedding(torch.from_numpy(t), 2 * half).numpy()
    want = np.asarray(junet.timestep_embedding(jnp.asarray(t), 2 * half))
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / half)
    one_ulp = t[:, None] * freqs[None] * 2.0 ** -23
    bound = np.concatenate([one_ulp, one_ulp], axis=1) + 2.0 ** -23
    assert (np.abs(got - want) <= bound).all()


def test_controlnet_branch_matches_jax(towers, inputs, jax_control):
    ldm = towers[0]
    with torch.no_grad():
        outs = ldm.control_model(nchw(inputs["x"]), nchw(inputs["hint"]),
                                 torch.from_numpy(inputs["t"]), torch.from_numpy(inputs["ctx"]))
    assert len(outs) == len(jax_control) == len(sd_unet.unet_layout(ldm.unet.cfg)[0]) + 1
    for got, want in zip(outs, jax_control):
        assert rel_err(nhwc(got), want) <= MODULE_RTOL


@pytest.mark.parametrize("with_control", [False, True])
def test_unet_matches_jax(towers, inputs, jax_control, with_control):
    ldm, params, (jucfg, _, _) = towers
    ctrl = [np.asarray(c) for c in jax_control] if with_control else None
    want = jax.jit(lambda p, x, t, c, ctrl: junet.SDUNet(jucfg).apply(
        {"params": p}, x, t, c, control=ctrl))(params["unet"], inputs["x"], inputs["t"],
                                                inputs["ctx"], ctrl)
    with torch.no_grad():
        got = ldm.unet(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                       torch.from_numpy(inputs["ctx"]),
                       control=[nchw(c) for c in ctrl] if with_control else None)
    assert rel_err(nhwc(got), want) <= MODULE_RTOL


def test_vae_encode_and_decode_match_jax(towers):
    ldm, params, (_, jvcfg, _) = towers
    g = np.random.RandomState(2)
    img = g.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    z = g.randn(1, 4, 6, 4).astype(np.float32)
    vae = jvae.AutoencoderKL(jvcfg)
    mean, logvar = jax.jit(lambda p, x: vae.apply({"params": p}, x, method=vae.encode))(
        params["vae"], img)
    dec = jax.jit(lambda p, z: vae.apply({"params": p}, z, method=vae.decode))(params["vae"], z)
    with torch.no_grad():
        m, lv = ldm.vae.encode(nchw(img))
        d = ldm.vae.decode(nchw(z))
    assert rel_err(nhwc(m), mean) <= MODULE_RTOL
    assert rel_err(nhwc(lv), logvar) <= MODULE_RTOL
    assert rel_err(nhwc(d), dec) <= MODULE_RTOL


def test_clip_text_tower_matches_jax(towers):
    ldm, params, (_, _, jccfg) = towers
    toks = np.random.RandomState(3).randint(0, VOCAB, (2, 77)).astype(np.int32)
    want = jax.jit(lambda p, t: jclip.CLIPTextEncoder(jccfg).apply({"params": p}, t))(
        params["clip"], toks)
    with torch.no_grad():
        got = ldm.clip(torch.from_numpy(toks))
    assert rel_err(got.numpy(), want) <= MODULE_RTOL


def test_tokenizer_ids_match_jax(tmp_path):
    vp, mp = write_tiny_vocab(tmp_path)
    mine, ref = clip_text.CLIPTokenizer(vp, mp, max_len=16), jclip.CLIPTokenizer(vp, mp, max_len=16)
    texts = ["hello world", "Hello,  WORLD!", "hello hello hello", "world... hello?",
             "a b c hello", "An image taken by dash cam in Zurich in a rainy night.",
             "&amp; café it's 42"]
    for text in texts:
        assert mine([text]).tolist() == ref([text]).tolist(), text
    assert np.array_equal(clip_text.load_tokenizer(str(tmp_path))(texts),
                          jclip.load_tokenizer(str(tmp_path))(texts))


def test_ddim_schedule_matches_jax():
    for steps in (50, 4, 20):
        for a, b in zip(sd_pipeline.ddim_schedule(steps), jpipe.ddim_schedule(steps)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for schedule in (sd_pipeline.ddim_schedule, jpipe.ddim_schedule):
        with pytest.raises(IndexError):  # arange(0, 1000, 333) + 1 reaches 1000
            schedule(3)
    assert np.array_equal(sd_pipeline.make_beta_schedule(), jpipe.make_beta_schedule())
