"""Row-partitioned whole-image eval: one image's rows in slabs over a list of
devices, the result equal to the unsplit forward.

Counterpart of ``multishiftseg_tpu/core/mesh.py::spatial_sharding`` (:73-88)
and ``train/test_runner.py::spatial_jit`` (:208-241). JAX shards the image's
height over an ``N``-device mesh in one process and XLA SPMD inserts the halo
exchanges and collectives. Here one process drives an explicit list of ``N``
devices (:func:`slab_devices`; a list may repeat a device) and the forward is
written out over :class:`Slabs`, slab ``i`` holding rows ``[i H / N, (i + 1) H
/ N)`` of every map at its stride on ``devices[i]``, with a replica of the
model's parameters on each device:

- an op with a vertical extent above 1 (a 3x3, 7x7 or strided conv, the max
  pool) reads the rows it needs from the slabs that hold them
  (:func:`fetch_rows`; zero rows, ``-inf`` for the pool, stand only above the
  image's first row and below its last) and runs with no vertical padding, so
  it computes its slab's rows and nothing else; the divisibility contract
  (height a multiple of ``N`` x the deepest stride) keeps every strided map's
  slabs aligned. A halo may span several slabs (DeepLab's rate-36 ASPP at
  ``N = 4``). The dilated conv's kernel (``ops.dilated_conv``) pads both axes
  itself: it runs unchanged on the slab with its halo rows and the slab's
  rows are kept, so ``2 x rate`` rows a slab are computed and thrown away
  (:func:`discarded_rows` counts them);
- reductions over the whole image sum over the slabs: the ASPP's image
  pooling (:meth:`SlabRunner.mean`) and every GroupNorm
  (:meth:`SlabRunner.group_norm`, the whole image's mean and variance);
- global coordinates: the sine position embedding and the deformable
  encoder's reference points are the whole level's, sliced by the slab's
  rows; a bilinear resize computes its slab's output rows from the source
  rows they read (``ops.resize.resize_bilinear_rows``);
- the deformable encoder: a slab's queries are its rows' tokens at each
  level, the value table the whole pyramid, gathered on every device, so
  every sample mode runs unchanged on the slab's queries;
- the transformer decoder runs whole, on the gathered multi-scale maps and
  mask features, on the first device; the score tails compute each slab's
  output rows (``ops.scores``' ``rows`` window, one kernel launch a slab).

Per-pixel ops (eval-mode BatchNorm, FrozenBN, ReLU, 1x1 convs, the FFNs and
norms of the encoder) run on each slab alone. Models: DeepLab WRN-38
(:func:`deeplab_forward`, deepest stride 8) and Mask2Former over a ResNet with
the msdeformattn pixel decoder (:func:`m2f_forward`, deepest stride 32).
"""

from __future__ import annotations

import copy
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_bilinear_rows, source_rows

DEEPLAB_STRIDE = 8   # WRN-38 at output stride 8
M2F_STRIDE = 32      # res5


class Slabs:
    """An NCHW map ``height`` rows tall split by rows: ``parts[i]`` holds rows
    ``[starts[i], starts[i] + parts[i].shape[2])`` on its device."""

    def __init__(self, parts: Sequence[torch.Tensor], starts: Sequence[int], height: int):
        self.parts, self.starts, self.height = list(parts), list(starts), height

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    @property
    def rows(self) -> List[Tuple[int, int]]:
        return [(s, p.shape[2]) for s, p in zip(self.starts, self.parts)]

    def map(self, fn) -> "Slabs":
        return Slabs([fn(p) for p in self.parts], self.starts, self.height)

    def gather(self, device=None) -> torch.Tensor:
        device = self.parts[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.parts], 2)


def add(a: Slabs, b: Slabs) -> Slabs:
    return Slabs([p + q for p, q in zip(a.parts, b.parts)], a.starts, a.height)


def cat(slabs: Sequence[Slabs]) -> Slabs:
    """Channel concatenation of maps that share their slabs."""
    first = slabs[0]
    return Slabs([torch.cat(ps, 1) for ps in zip(*(s.parts for s in slabs))], first.starts,
                 first.height)


def split_rows(x: torch.Tensor, devices: Sequence[torch.device]) -> Slabs:
    """``x`` [N, C, H, W] in ``len(devices)`` slabs of ``H / len(devices)`` rows."""
    n, h = len(devices), x.shape[2]
    per = h // n
    return Slabs([x[:, :, i * per:(i + 1) * per].to(d) for i, d in enumerate(devices)],
                 [i * per for i in range(n)], h)


def fetch_rows(s: Slabs, lo: int, hi: int, device, fill: float = 0.0) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``s`` on ``device``, from whichever slabs hold them;
    rows outside the map are ``fill``."""
    ref = s.parts[0]
    n, c, _, w = ref.shape
    pieces = []
    if lo < 0:
        pieces.append(torch.full((n, c, min(hi, 0) - lo, w), fill, dtype=ref.dtype,
                                 device=device))
    for part, start in zip(s.parts, s.starts):
        a, b = max(lo, start), min(hi, start + part.shape[2])
        if a < b:
            pieces.append(part[:, :, a - start:b - start].to(device))
    if hi > s.height:
        pieces.append(torch.full((n, c, hi - max(lo, s.height), w), fill, dtype=ref.dtype,
                                 device=device))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 2)


def check_height(height: int, slabs: int, min_stride: int) -> None:
    """JAX ``spatial_jit``'s contract (``test_runner.py:231-237``): every feature
    level's height splits evenly over the slabs."""
    need = slabs * min_stride
    if height % need:
        raise ValueError(
            f"image height {height} not divisible by {need} (= {slabs} spatial devices x "
            f"deepest stride {min_stride}); pad the eval bucket (OODEvaluator "
            f"bucket_multiple) so every feature level shards evenly")


def spatial_bucket_multiple(spatial_devices: int, min_stride: int = 32,
                            base: int = 128) -> int:
    """Eval bucket granularity that satisfies :func:`check_height` (JAX
    ``test_runner.py:244-252``): lcm(base, devices x deepest stride)."""
    if spatial_devices <= 0:
        return base
    need = spatial_devices * min_stride
    return base * need // math.gcd(base, need)


def slab_devices(n: int, devices: Optional[Sequence] = None,
                 home: Optional[torch.device] = None) -> List[torch.device]:
    """The ``n`` slabs' devices: ``devices``, or ``n`` copies of a CPU ``home``,
    or the first ``n`` cards. Refuses a list of another length, and fewer
    cards than ``n``, as JAX's ``make_mesh`` refuses to truncate (a list may
    repeat a device: every slab on one card)."""
    if n < 1:
        raise ValueError(f"spatial devices = {n}: at least one slab")
    if devices is None:
        home = torch.device("cuda" if home is None else home)
        if home.type == "cpu":
            devices = [home] * n
        else:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if count < n:
                raise ValueError(f"--spatial {n} needs {n} cards; {count} are present "
                                 "(refusing to run fewer slabs)")
            devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if len(devs) != n:
        raise ValueError(f"{n} slabs but {len(devs)} devices ({[str(d) for d in devs]})")
    return devs


def discarded_rows(model: nn.Module, height: int, slabs: int) -> Tuple[int, int]:
    """(rows computed and thrown away, rows kept) by the dilated conv's kernel
    over ``slabs`` slabs of an image ``height`` rows tall: each ASPP branch at
    rate r runs on a slab's rows plus ``2 r`` halo rows at stride 8."""
    from ..models.layers import DilatedConv2d

    rates = [m.dilation[0] for m in model.modules() if isinstance(m, DilatedConv2d)]
    rows = height // DEEPLAB_STRIDE
    return sum(2 * r * slabs for r in rates), len(rates) * rows


class SlabRunner:
    """Runs layers of ``model`` over :class:`Slabs`, each slab with the
    replica of the model on its device (the model itself on its own device).
    ``model`` is in eval mode; every layer a slab meets is one this module
    knows the vertical extent of, or it raises."""

    def __init__(self, model: nn.Module, devices: Sequence[torch.device]):
        self.model = model
        self.home = next(model.parameters()).device
        self.devices = [torch.device(d) for d in devices]
        self.names = {id(m): n for n, m in model.named_modules()}
        self.replicas: Dict[torch.device, Dict[str, nn.Module]] = {}
        for dev in dict.fromkeys(self.devices):
            replica = model if dev == self.home else copy.deepcopy(model).to(dev).eval()
            self.replicas[dev] = dict(replica.named_modules())

    def on(self, layer: nn.Module, device: torch.device) -> nn.Module:
        """``layer``'s replica on ``device``."""
        return self.replicas[torch.device(device)][self.names[id(layer)]]

    def each(self, layer: nn.Module, s: Slabs) -> Slabs:
        """A per-pixel ``layer`` on each slab."""
        return Slabs([self.on(layer, p.device)(p) for p in s.parts], s.starts, s.height)

    def run(self, layer: Optional[nn.Module], s: Slabs) -> Slabs:
        from ..models.layers import BatchNorm2d, Dropout2d
        from ..models.resnet import FrozenBN
        from .tensor_parallel import ChannelShards

        if layer is None:
            return s
        if isinstance(layer, nn.Sequential):
            for sub in layer:
                s = self.run(sub, s)
            return s
        if isinstance(layer, ChannelShards):
            raise NotImplementedError("the row-partitioned eval takes an unsharded model")
        if isinstance(layer, nn.Conv2d):
            return self.conv(layer, s)
        if isinstance(layer, nn.GroupNorm):
            return self.group_norm(layer, s)
        if isinstance(layer, (BatchNorm2d, FrozenBN, nn.ReLU, Dropout2d)):
            if layer.training:
                raise ValueError("the row-partitioned eval runs the model in eval mode")
            return self.each(layer, s)
        raise NotImplementedError(f"{type(layer).__name__}: no row-partitioned route")

    def conv(self, module: nn.Conv2d, s: Slabs) -> Slabs:
        """A conv over the slabs with its halo rows, then a detectron2
        ``Conv2d``'s norm and activation."""
        from ..models.layers import DilatedConv2d

        k, st = module.kernel_size[0], module.stride[0]
        p, d = module.padding[0], module.dilation[0]
        if module.padding_mode != "zeros" or isinstance(module.padding, str):
            raise NotImplementedError("row-partitioned convs pad with zeros")
        parts, starts = [], []
        for (start, count), dev in zip(s.rows, s.devices):
            if start % st or count % st:
                raise ValueError(f"slab rows [{start}, {start + count}) do not align with "
                                 f"stride {st}")
            mod = self.on(module, dev)
            if isinstance(module, DilatedConv2d):
                x = fetch_rows(s, start - d, start + count + d, dev)
                y = mod(x)[:, :, d:d + count]
            else:
                o0, o1 = start // st, (start + count) // st
                x = fetch_rows(s, o0 * st - p, (o1 - 1) * st - p + d * (k - 1) + 1, dev)
                y = F.conv2d(x, mod.weight, mod.bias, mod.stride, (0, mod.padding[1]),
                             mod.dilation, mod.groups)
            parts.append(y)
            starts.append(start // st)
        out = Slabs(parts, starts, s.height // st)
        if getattr(module, "norm", None) is not None:
            out = self.run(module.norm, out)
        if getattr(module, "activation", None) is not None:
            out = out.map(module.activation)
        return out

    def max_pool(self, s: Slabs, k: int = 3, st: int = 2, p: int = 1) -> Slabs:
        parts = []
        for (start, count), dev in zip(s.rows, s.devices):
            o0, o1 = start // st, (start + count) // st
            x = fetch_rows(s, o0 * st - p, (o1 - 1) * st - p + k, dev, float("-inf"))
            parts.append(F.max_pool2d(x, k, st, padding=(0, p)))
        return Slabs(parts, [a // st for a in s.starts], s.height // st)

    def mean(self, s: Slabs) -> torch.Tensor:
        """The whole map's mean over H and W, [N, C, 1, 1] on the home device."""
        total = sum(p.float().sum((2, 3), keepdim=True).to(self.home) for p in s.parts)
        return (total / (s.height * s.parts[0].shape[3])).to(s.parts[0].dtype)

    def group_norm(self, gn: nn.GroupNorm, s: Slabs) -> Slabs:
        """GroupNorm with the whole image's per-group mean and variance, summed
        over the slabs (two passes, in f32); f32 out under autocast, as
        ``nn.GroupNorm``, else in the input's type."""
        n, c, _, w = s.parts[0].shape
        g = gn.num_groups
        count = (c // g) * s.height * w
        xs = [p.float().reshape(n, g, -1) for p in s.parts]
        mean = sum(x.sum(-1).to(self.home) for x in xs) / count
        var = sum(((x - mean.to(x.device)[..., None]) ** 2).sum(-1).to(self.home)
                  for x in xs) / count
        inv = torch.rsqrt(var + gn.eps)
        auto = torch.is_autocast_enabled(self.home.type)
        parts = []
        for x, part in zip(xs, s.parts):
            mod = self.on(gn, part.device)
            y = ((x - mean.to(x.device)[..., None]) * inv.to(x.device)[..., None])
            y = y.reshape(part.shape) * mod.weight.float()[:, None, None] \
                + mod.bias.float()[:, None, None]
            parts.append(y if auto else y.to(part.dtype))
        return Slabs(parts, s.starts, s.height)

    def resize(self, src: Slabs, like: Slabs, out_hw: Tuple[int, int],
               align_corners: bool) -> Slabs:
        """The bilinear resize of ``src`` to ``out_hw``, in ``like``'s slabs
        (``like`` holds rows of an ``out_hw`` map): each slab's output rows
        from the source rows they read."""
        parts = []
        for (start, count), dev in zip(like.rows, like.devices):
            i0, i1, _ = source_rows(src.height, out_hw[0], (start, count), align_corners)
            lo, hi = int(i0.min()), int(i1.max()) + 1
            window = fetch_rows(src, lo, hi, dev)
            parts.append(resize_bilinear_rows(window, out_hw, (start, count), align_corners,
                                              in_h=src.height, in_row0=lo))
        return Slabs(parts, like.starts, out_hw[0])


# ---------------------------------------------------------------------------
# DeepLab


def _wrn_block(r: SlabRunner, block, s: Slabs) -> Slabs:
    bn1 = r.run(block.bn1, s)
    shortcut = r.run(block.proj_conv, bn1) if block.proj_conv is not None else s
    return add(r.run(block.convs, bn1), shortcut)


def deeplab_forward(model, x: torch.Tensor, devices: Sequence[torch.device],
                    runner: Optional[SlabRunner] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``DeepWV3Plus.forward`` in eval mode over row slabs: x [N, 3, H, W] ->
    (score [N, H, W], logit [N, C, H, W]) on the first device."""
    from ..ops.scores import energy_score

    r = runner or SlabRunner(model, devices)
    h, w = x.shape[2:]
    check_height(h, len(devices), DEEPLAB_STRIDE)
    image = split_rows(x.to(next(model.parameters()).dtype), devices)
    s = r.run(model.mod1, image)
    m2 = s
    for mod_id in range(model.num_mods):
        if mod_id < 2:
            s = r.max_pool(s)
        for block in getattr(model, f"mod{mod_id + 2}").children():
            s = _wrn_block(r, block, s)
        if mod_id == 0:
            m2 = s
    aspp = model.aspp
    img = aspp.img_conv(r.mean(s))
    pooled = Slabs([img.to(p.device).expand(-1, -1, p.shape[2], p.shape[3]) for p in s.parts],
                   s.starts, s.height)
    branches = cat([pooled] + [r.run(f, s) for f in aspp.features])
    dec0_up = r.run(model.bot_aspp, branches)
    m2_hw = (m2.height, m2.parts[0].shape[3])
    dec0 = cat([r.run(model.bot_fine, m2), r.resize(dec0_up, m2, m2_hw, True)])
    feature = r.run(model.final[:6], dec0)
    logit = r.run(model.final[6], feature).map(lambda t: t.float())
    score = r.run(model.ood_head, feature).map(lambda t: energy_score(t, dim=1)[:, None])
    logit = r.resize(logit, image, (h, w), True).gather()
    score = r.resize(score, image, (h, w), True).gather()[:, 0]
    return score, logit


# ---------------------------------------------------------------------------
# Mask2Former


def _resnet(r: SlabRunner, backbone, s: Slabs) -> Dict[str, Slabs]:
    from ..models.resnet import BottleneckBlock

    s = r.max_pool(r.run(backbone.stem.conv1, s).map(F.relu))
    feats = {}
    for name in ("res2", "res3", "res4", "res5"):
        for block in getattr(backbone, name):
            shortcut = r.run(block.shortcut, s) if block.shortcut is not None else s
            out = r.run(block.conv1, s).map(F.relu)
            if isinstance(block, BottleneckBlock):
                out = r.run(block.conv2, out).map(F.relu)
                out = r.run(block.conv3, out)
            else:
                out = r.run(block.conv2, out)
            s = add(out, shortcut).map(F.relu)
        feats[name] = s
    return feats


def _level_tokens(p: torch.Tensor) -> torch.Tensor:
    return p.flatten(2).transpose(1, 2)  # [N, rows * W, C]


def _pixel_decoder(r: SlabRunner, pd, feats: Dict[str, Slabs], modes: Sequence[str],
                   quantize: bool) -> Tuple[Slabs, List[Slabs]]:
    """``MSDeformAttnPixelDecoder.forward`` over the slabs -> (mask features,
    multi-scale maps low -> high resolution)."""
    from ..models.pixel_decoder import ENCODER_FEATURES, FPN_FEATURE
    from ..ops.ms_deform_attn import ms_deform_attn_core

    levels = [r.run(proj, feats[name]) for proj, name in zip(pd.input_proj, ENCODER_FEATURES)]
    shapes = [(lv.height, lv.parts[0].shape[3]) for lv in levels]
    level_start = [0]
    for h, w in shapes[:-1]:
        level_start.append(level_start[-1] + h * w)
    n_slabs = len(r.devices)
    srcs, poss, refs = [], [], []
    for j, dev in enumerate(r.devices):
        pdj = r.on(pd, dev)
        pos_levels, ref = pdj._pos_and_ref(shapes, dev)
        idx, pos = [], []
        dtype = levels[0].parts[j].dtype
        embed = pdj.transformer.level_embed.to(dtype)
        for lvl, (lv, (h, w)) in enumerate(zip(levels, shapes)):
            start, count = lv.rows[j]
            idx.append(torch.arange(start * w, (start + count) * w, device=dev)
                       + level_start[lvl])
            pos.append(pos_levels[lvl][start * w:(start + count) * w].to(dtype) + embed[lvl])
        idx = torch.cat(idx)
        srcs.append(torch.cat([_level_tokens(lv.parts[j]) for lv in levels], 1))
        poss.append(torch.cat(pos)[None])
        refs.append(ref[idx][None, :, None, :].expand(1, -1, len(shapes), -1))
    # slab j's tokens of level l: [offset, offset + count) of its sequence
    counts = [[lv.rows[j][1] * w for lv, (_, w) in zip(levels, shapes)]
              for j in range(n_slabs)]
    for i, mode in enumerate(modes):
        layers = [r.on(pd.transformer.encoder.layers[i], dev) for dev in r.devices]
        values = [layer.self_attn.value(src) for layer, src in zip(layers, srcs)]
        new = []
        for j, (layer, dev) in enumerate(zip(layers, r.devices)):
            table = []
            for lvl in range(len(shapes)):
                for k in range(n_slabs):
                    off = sum(counts[k][:lvl])
                    table.append(values[k][:, off:off + counts[k][lvl]].to(dev))
            table = torch.cat(table, 1)
            n = srcs[j].shape[0]
            loc, attn = layer.self_attn.locations(srcs[j] + poss[j].expand(n, -1, -1),
                                                  refs[j].expand(n, -1, -1, -1), shapes)
            core = ms_deform_attn_core(table, shapes, loc, attn.to(table.dtype), mode, quantize)
            new.append(layer._finish(srcs[j], core))
        srcs = new
    outs = []
    for lvl, (lv, (h, w)) in enumerate(zip(levels, shapes)):
        parts = []
        for j in range(n_slabs):
            off = sum(counts[j][:lvl])
            t = srcs[j][:, off:off + counts[j][lvl]]
            parts.append(t.transpose(1, 2).reshape(t.shape[0], -1, lv.rows[j][1], w))
        outs.append(Slabs(parts, lv.starts, h))
    x = feats[FPN_FEATURE]
    x_hw = (x.height, x.parts[0].shape[3])
    y = add(r.run(pd.adapter_1, x), r.resize(outs[-1], x, x_hw, False))
    return r.run(pd.mask_features, r.run(pd.layer_1, y)), outs


def m2f_forward(model, images: torch.Tensor, devices: Sequence[torch.device],
                deform_sample_mode="bilinear", quantize_deform_table: bool = False,
                runner: Optional[SlabRunner] = None) -> Dict[str, object]:
    """``MaskFormer.forward`` in eval mode over row slabs: the ResNet backbone
    and the msdeformattn pixel decoder slab by slab, the transformer decoder
    whole on the first device. images [N, H, W, 3] normalised -> the
    predictor's output dict on the first device."""
    from ..models.resnet import ResNet

    if model.pixel_decoder_name != "msdeformattn" or not isinstance(model.backbone, ResNet):
        raise NotImplementedError("the row-partitioned eval runs a ResNet backbone and the "
                                  "msdeformattn pixel decoder")
    r = runner or SlabRunner(model, devices)
    check_height(images.shape[1], len(devices), M2F_STRIDE)
    pd = model.sem_seg_head.pixel_decoder
    n_layers = len(pd.transformer.encoder.layers)
    modes = ((deform_sample_mode,) * n_layers if isinstance(deform_sample_mode, str)
             else tuple(deform_sample_mode))
    if len(modes) != n_layers:
        raise ValueError(f"per-layer sample_mode needs {n_layers} entries, got {len(modes)}")
    x = images.permute(0, 3, 1, 2).to(next(model.backbone.parameters()).dtype)
    feats = _resnet(r, model.backbone, split_rows(x, devices))
    mask_features, multi_scale = _pixel_decoder(r, pd, feats, modes, quantize_deform_table)
    home = r.home
    return model.sem_seg_head.predictor([m.gather(home) for m in multi_scale],
                                        mask_features.gather(home))


def m2f_inference(outputs: Dict[str, torch.Tensor], image_hw: Tuple[int, int],
                  devices: Sequence[torch.device], num_classes: int = 19,
                  score_lowres: bool = False, score_topq: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``models.maskformer.inference`` slab by slab: each device computes its
    slab's output rows of both tails (the score tail's row window) from the
    whole mask predictions; the rows are gathered on the first device."""
    from ..models.maskformer import inference

    h = image_hw[0]
    per = h // len(devices)
    sems, anomalies = [], []
    for i, dev in enumerate(devices):
        local = {k: outputs[k].to(dev) for k in ("pred_logits", "pred_masks",
                                                 "pred_logits_ood", "pred_masks_ood")}
        sem, anomaly = inference(local, image_hw, num_classes, score_lowres=score_lowres,
                                 score_topq=score_topq, rows=(i * per, per))
        sems.append(sem)
        anomalies.append(anomaly)
    home = devices[0]
    return (torch.cat([s.to(home) for s in sems], 2),
            torch.cat([a.to(home) for a in anomalies], 1))


def m2f_eval(model, imgs: torch.Tensor, devices: Sequence[torch.device], bf16: bool = False,
             sample_mode: str = "bilinear", score_lowres: bool = False, score_topq: int = 0,
             runner: Optional[SlabRunner] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``train.m2f_trainer.eval_forward`` over row slabs: normalised f32 images
    [B, H, W, 3] -> (sem [B, K + Q, H, W], anomaly [B, H, W]) on the first
    device; every sample mode and either approximate tail. ``int8`` takes its
    scale per image, as there."""
    from ..models.pixel_decoder import DEFORM_POINTS
    from ..ops.ms_deform_attn import parse_eval_sample_mode

    deform_mode, quantize = parse_eval_sample_mode(sample_mode, DEFORM_POINTS)
    r = runner or SlabRunner(model, devices)
    x = torch.as_tensor(imgs).to(r.home)
    model.eval()
    hw = tuple(x.shape[1:3])

    def run(part):
        with torch.autocast(r.home.type, dtype=torch.bfloat16, enabled=bf16):
            outputs = m2f_forward(model, part, devices, deform_mode, quantize, runner=r)
        return m2f_inference(outputs, hw, devices, model.num_classes, score_lowres,
                             score_topq)

    parts = [run(part) for part in (x.split(1) if quantize else (x,))]
    return tuple(torch.cat(t) if len(parts) > 1 else t[0] for t in zip(*parts))
