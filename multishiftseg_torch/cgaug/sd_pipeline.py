"""ControlNet-SD1.5 generation: schedules, DDIM with classifier-free guidance, decode.

Counterpart of ``multishiftseg_tpu/cgaug/sd_pipeline.py``, reproducing the
reference's generation loop (``CGAug/generate_multishift_image.py:107-137`` and
``ControlNet/cldm/ddim_hacked.py``):

* the linear beta schedule of 1000 DDPM steps, in float64 then f32
  (``linspace(sqrt(0.00085), sqrt(0.012))**2``);
* the uniform DDIM subsequence ``arange(0, 1000, 1000 // S) + 1``;
* the eta = 0, epsilon-parameterised update (``p_sample_ddim:203-231``);
* guidance 9.0 with the seg hint on both branches (the unconditional branch
  keeps ``c_concat``), cond and uncond as one batch of 2N;
* latent scale factor 0.18215, the VAE decode mapped to [0, 255].

The sampler is a plain loop over the steps on the device: the step's
coefficients are host floats computed in f32 as JAX's scan computes them, and
nothing inside the loop waits for the card. :class:`ControlLDM` holds the four
towers under the checkpoint's names, so :func:`load_control_sd15` loads
``control_sd15_seg.pth`` strictly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..utils import resolve_device
from .clip_text import CLIPTextConfig, CLIPTextEncoder
from .sd_unet import ControlNetBranch, SDUNet, SDUNetConfig
from .sd_vae import AutoencoderKL, VAEConfig


def make_beta_schedule(n: int = 1000, linear_start: float = 0.00085,
                       linear_end: float = 0.012) -> np.ndarray:
    """util.py:21-26 linear schedule, computed in float64 like the reference."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n,
                       dtype=np.float64) ** 2


def ddim_schedule(num_steps: int, num_train: int = 1000,
                  linear_start: float = 0.00085, linear_end: float = 0.012,
                  eta: float = 0.0):
    """-> (timesteps [S], a_t [S], a_prev [S], sigma_t [S]) f32 arrays, in
    sampling order index 0 = smallest t (the reference iterates index S-1..0)."""
    betas = make_beta_schedule(num_train, linear_start, linear_end)
    acp = np.cumprod(1.0 - betas)
    c = num_train // num_steps
    ts = np.arange(0, num_train, c) + 1
    a = acp[ts]
    a_prev = np.concatenate([[acp[0]], acp[ts[:-1]]])
    sigma = eta * np.sqrt((1 - a_prev) / (1 - a) * (1 - a / a_prev))
    return (ts.astype(np.int32), a.astype(np.float32),
            a_prev.astype(np.float32), sigma.astype(np.float32))


def ddim_coefficients(num_steps: int, num_train: int = 1000, eta: float = 0.0):
    """The DDIM steps in sampling order: (t, sqrt(1 - a_t), sqrt(a_t),
    sqrt(1 - a_prev - sigma^2), sqrt(a_prev), sigma) as Python floats, each
    computed in f32 from the f32 schedule, as JAX's update computes them."""
    ts, a_t, a_prev, sigma = ddim_schedule(num_steps, num_train, eta=eta)
    one = np.float32(1.0)
    rows = zip(ts[::-1], np.sqrt(one - a_t)[::-1], np.sqrt(a_t)[::-1],
               np.sqrt(one - a_prev - sigma ** 2)[::-1], np.sqrt(a_prev)[::-1], sigma[::-1])
    return [(int(t), *(float(v) for v in r)) for t, *r in rows]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    steps: int = 50
    guidance_scale: float = 9.0
    eta: float = 0.0
    num_train_timesteps: int = 1000
    scale_factor: float = 0.18215
    control_scale: float = 1.0


class _Holder(nn.Module):
    """A named level of the checkpoint's module tree (``model``,
    ``cond_stage_model.transformer``)."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


class ControlLDM(nn.Module):
    """The four towers of a cldm-v15 checkpoint under its names:
    ``model.diffusion_model`` (UNet), ``control_model`` (ControlNet),
    ``first_stage_model`` (VAE), ``cond_stage_model.transformer.text_model`` (CLIP)."""

    def __init__(self, unet_cfg: SDUNetConfig = SDUNetConfig(),
                 vae_cfg: VAEConfig = VAEConfig(), clip_cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.model = _Holder(diffusion_model=SDUNet(unet_cfg))
        self.control_model = ControlNetBranch(unet_cfg)
        self.first_stage_model = AutoencoderKL(vae_cfg)
        self.cond_stage_model = _Holder(
            transformer=_Holder(text_model=CLIPTextEncoder(clip_cfg)))

    @property
    def unet(self) -> SDUNet:
        return self.model.diffusion_model

    @property
    def vae(self) -> AutoencoderKL:
        return self.first_stage_model

    @property
    def clip(self) -> CLIPTextEncoder:
        return self.cond_stage_model.transformer.text_model


# what a cldm-v15 checkpoint holds beyond the four towers: LatentDiffusion's
# DDPM schedule buffers (ddpm.py register_schedule), its scale factor and
# logvar, and the text model's position ids. The loader drops exactly these.
CHECKPOINT_EXTRAS = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "scale_factor", "logvar",
    "cond_stage_model.transformer.text_model.embeddings.position_ids"))


def load_control_sd15(path: str, **cfgs) -> ControlLDM:
    """``control_sd15_seg.pth`` -> :class:`ControlLDM` on the CPU, loaded
    strictly (a flat state dict or ``{"state_dict": ...}``, as cldm/model.py's
    ``load_state_dict`` accepts)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    ldm = ControlLDM(**cfgs)
    ldm.load_state_dict({k: v for k, v in state.items() if k not in CHECKPOINT_EXTRAS},
                        strict=True)
    return ldm.eval()


class ControlNetPipeline:
    """Text encode, DDIM sampling and decode over a :class:`ControlLDM`.

    Latents and hints are NCHW: latents [N, 4, H/8, W/8], the hint [N, 3, H, W]
    in [0, 1]. The towers run in their configs' dtype (their weights are cast
    to it here)."""

    def __init__(self, ldm: ControlLDM, sampler: SamplerConfig = SamplerConfig()):
        self.ldm = ldm.eval()
        for tower in (ldm.unet, ldm.control_model, ldm.vae, ldm.clip):
            tower.to(tower.cfg.dtype)
        self.sampler = sampler
        self.steps = ddim_coefficients(sampler.steps, sampler.num_train_timesteps, sampler.eta)

    @property
    def device(self) -> torch.device:
        return next(self.ldm.parameters()).device

    @torch.no_grad()
    def encode_text(self, tokens) -> torch.Tensor:
        return self.ldm.clip(torch.as_tensor(np.asarray(tokens), device=self.device))

    def eps(self, x, hint, t, context):
        """cond/uncond stacked eps prediction with the control residuals."""
        ctrl = self.ldm.control_model(x, hint, t, context)
        ctrl = [c * self.sampler.control_scale for c in ctrl]
        return self.ldm.unet(x, t, context, control=ctrl)

    @torch.no_grad()
    def sample(self, x_T: torch.Tensor, hint: torch.Tensor, ctx_cond: torch.Tensor,
               ctx_uncond: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """DDIM sampling from ``x_T``. ``generator`` draws the ``sigma_t * noise``
        term, which only ``eta > 0`` uses."""
        cfg = self.sampler
        n = x_T.shape[0]
        hint2 = torch.cat([hint, hint])
        ctx2 = torch.cat([ctx_cond, ctx_uncond])
        x = x_T.float()
        for t, s1a, sa, sdir, sap, sg in self.steps:
            t2 = torch.full((2 * n,), t, dtype=torch.int32, device=x.device)
            eps2 = self.eps(torch.cat([x, x]), hint2, t2, ctx2).float()
            eps_c, eps_u = eps2[:n], eps2[n:]
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            pred_x0 = (x - s1a * eps) / sa
            x = sap * pred_x0 + sdir * eps
            if sg:
                x = x + sg * torch.randn(x.shape, generator=generator, device=x.device)
        return x

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents -> RGB float [N, 3, H, W] in [0, 255] (decode_first_stage,
        then generate_multishift_image.py:136-138's x * 127.5 + 127.5)."""
        x = self.ldm.vae.decode(z / self.sampler.scale_factor).float()
        return torch.clamp(x * 127.5 + 127.5, 0.0, 255.0)

    def generate_latents(self, hint, tokens_cond, tokens_uncond, x_T) -> torch.Tensor:
        return self.sample(x_T, hint, self.encode_text(tokens_cond),
                           self.encode_text(tokens_uncond))


def draw_latent_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """x_T ~ N(0, 1) of ``shape`` from ``generator`` (the one draw of a
    generation; JAX draws it from the next split of its key chain)."""
    return torch.randn(shape, generator=generator, device=device)


class SDControlNetGenerator:
    """:class:`cgaug.generate.DiffusionBackend` over a ControlNet-SD1.5 checkpoint.

    ``generate`` takes the ADE20K-palette label map [H, W, 3] uint8 and the
    prompt, as the reference's ``Semantic2ImageGenerator.generate`` (its
    a_prompt / n_prompt applied here), and returns [H, W, 3] uint8 (the float
    image truncated, as JAX's ``astype``). x_T comes from a ``torch.Generator``
    on the device seeded with ``seed``. Runs on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    A_PROMPT = "best quality, extremely detailed"
    N_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing fingers, "
                "extra digit, fewer digits, cropped, worst quality, low quality")

    def __init__(self, ldm: ControlLDM, tokenizer, seed: int = 0, device="cuda",
                 sampler: SamplerConfig = SamplerConfig()):
        self.device = resolve_device(device)
        self.pipe = ControlNetPipeline(ldm.to(self.device), sampler)
        self.tokenizer = tokenizer
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def generate(self, seg_label_rgb: np.ndarray, prompt: str) -> np.ndarray:
        h, w = seg_label_rgb.shape[:2]
        hint = torch.from_numpy(np.ascontiguousarray(seg_label_rgb)).to(self.device)
        hint = hint.permute(2, 0, 1)[None].float() / 255.0
        toks_c = self.tokenizer([f"{prompt}, {self.A_PROMPT}"])
        toks_u = self.tokenizer([self.N_PROMPT])
        x_T = draw_latent_noise(self.generator, (1, 4, h // 8, w // 8), self.device)
        z = self.pipe.generate_latents(hint, toks_c, toks_u, x_T)
        img = self.pipe.decode(z)
        return img[0].permute(1, 2, 0).cpu().numpy().astype(np.uint8)
