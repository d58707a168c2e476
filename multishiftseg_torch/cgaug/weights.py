"""The pretrained weights of the CG-Aug reference path, read from local files.

Counterpart of ``multishiftseg_tpu/cgaug/weights.py``. ``WEIGHT_URLS`` is JAX's
registry, copied. :func:`fetch_weight` downloads nothing: it returns the file
under ``download_dir`` and raises, naming the URL and the destination, when the
file is absent (JAX's downloads it). :func:`build_real_backends` assembles the
reference's generation stack from those files.
"""

from __future__ import annotations

import os
from typing import Dict

# name -> (url, filename); gdrive: prefix means no direct download
WEIGHT_URLS: Dict[str, tuple] = {
    # SAM ViT-H for generation-quality filtering (CGAug/download.py:7)
    "sam_vit_h": (
        "https://dl.fbaipublicfiles.com/segment_anything/sam_vit_h_4b8939.pth",
        "sam_vit_h_4b8939.pth",
    ),
    # ControlNet seg-conditioned SD 1.5 (CGAug/download.py:27-33)
    "control_sd15_seg": (
        "https://huggingface.co/lllyasviel/ControlNet/resolve/main/models/"
        "control_sd15_seg.pth",
        "control_sd15_seg.pth",
    ),
    # Mask2Anomaly Barlow-Twins R-50 init for M2F fine-tuning (README.md:120-122)
    "bt-f-xl": (
        "gdrive:1UVms08chnBkZta_cNumjiei6GByyM9VN",
        "bt-f-xl.pth",
    ),
    # the released fine-tuned checkpoints behind the README benchmark table
    # (README.md:140-146, Hugging Face mirrors of the gdrive links)
    "deeplab_best": (
        "https://huggingface.co/Cuttle-fish-my/MultiShiftSeg/resolve/main/"
        "DeepLab_best.pth",
        "DeepLab_best.pth",
    ),
    "m2f_best": (
        "https://huggingface.co/Cuttle-fish-my/MultiShiftSeg/resolve/main/"
        "M2F_best.pth",
        "M2F_best.pth",
    ),
    # Swin IN21k pretrains for the swin experiment configs
    "swin_large_22k": (
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/"
        "swin_large_patch4_window12_384_22k.pth",
        "swin_large_patch4_window12_384_22k.pth",
    ),
    "swin_tiny_1k": (
        "https://github.com/SwinTransformer/storage/releases/download/v1.0.0/"
        "swin_tiny_patch4_window7_224.pth",
        "swin_tiny_patch4_window7_224.pth",
    ),
    # CLIP BPE tokenizer assets for the SD text conditioning (FrozenCLIPEmbedder
    # uses openai/clip-vit-large-patch14; vocab/merges are model-agnostic)
    "clip_vocab": (
        "https://huggingface.co/openai/clip-vit-large-patch14/resolve/main/vocab.json",
        "clip/vocab.json",
    ),
    "clip_merges": (
        "https://huggingface.co/openai/clip-vit-large-patch14/resolve/main/merges.txt",
        "clip/merges.txt",
    ),
}


def fetch_weight(name: str, download_dir: str = "pretrained_model") -> str:
    """The local path of a registered weight; raises ``FileNotFoundError``
    naming where to download it from and where to put it when it is absent."""
    url, filename = WEIGHT_URLS[name]
    dest = os.path.join(download_dir, filename)
    if os.path.isfile(dest):
        return dest
    source = (f"Google Drive (id {url[7:]})" if url.startswith("gdrive:") else url)
    raise FileNotFoundError(
        f"{name} is not at {dest}; this package downloads nothing: fetch it from "
        f"{source} and place it at {dest}")


def build_real_backends(download_dir: str = "pretrained_model", device="cuda"):
    """The reference's generation stack (generate_multishift_image.py:44-58)
    from the files under ``download_dir``: (SDControlNetGenerator over
    control_sd15_seg.pth with CLIP's tokenizer, SAMSegmenter over
    sam_vit_h_4b8939.pth), both on ``device``."""
    from .clip_text import load_tokenizer
    from .sam import SAMSegmenter, load_sam, sam_vit_h
    from .sd_pipeline import SDControlNetGenerator, load_control_sd15

    ldm = load_control_sd15(fetch_weight("control_sd15_seg", download_dir))
    fetch_weight("clip_vocab", download_dir)
    fetch_weight("clip_merges", download_dir)
    tok = load_tokenizer(os.path.join(download_dir, "clip"))
    gen = SDControlNetGenerator(ldm, tok, device=device)
    seg = SAMSegmenter(load_sam(fetch_weight("sam_vit_h", download_dir), sam_vit_h()),
                       device=device)
    return gen, seg
