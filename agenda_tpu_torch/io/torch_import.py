"""mmdet/mmyolo checkpoints -> the port's detectors (the reference's ``load_from``).

Counterpart of ``agenda_tpu/io/torch_import.py``. The reference starts every
Real_Source detector from a COCO checkpoint through ``load_from``
(``Real_Source/faster-rcnn.py:37``, ``yolov5.py:40``, ``yolov8.py:57``,
``vitdet.py:43``). This module maps those state dicts (mmdet, mmyolo and
mmdet-ViTDet names; torchvision's for a bare ResNet) onto a family's
variables by the JAX importer's own rules, key by key, so that the same
tensors land in the same places:

- each mm key maps to the flax name the JAX import fills (the family maps
  ``_map_faster_rcnn``, ``_map_yolov5``, ``_map_yolov8``, ``_map_vitdet``,
  copied here), with the JAX import's layout changes: convolution
  ``weight`` OIHW -> ``kernel`` HWIO, linear (out, in) -> (in, out), the
  Shared2FC head's first fc un-flattened from NCHW to NHWC, batch-norm
  ``running_*`` -> ``batch_stats``, norm ``weight`` -> ``scale``; a ViT
  ``pos_embed`` loses a leading cls token and is resized bilinearly, and
  the rel-pos tables are interpolated to the model's length;
- the filled flax variables then go to the ``state_dict`` through the
  family's converter (``from_flax``), so "the same tensors as the JAX
  import" holds by construction;
- the class-count heads (80-class COCO against one class) do not fit and
  are skipped, as mmengine's non-strict ``load_from`` skips them;
  ``ImportReport`` lists what was imported, skipped, unmatched and missing.

``.pth`` files load with ``torch.load(weights_only=True)``, ``.safetensors``
through the port's own reader. ``_resize_pos_embed`` is Pillow's
``BILINEAR`` on a mode-F image without Pillow (the card's machine has
none): its normalised float64 filter rows (``augment.pil_float_matrix``),
the width pass then the height pass, each rounded to f32 as Pillow stores
its intermediate image.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from agenda_tpu_torch.detect.augment import pil_float_matrix
from agenda_tpu_torch.io.safetensors_io import load_file

logger = logging.getLogger("agenda_tpu_torch.torch_import")

Path = Tuple[str, ...]


# ---------------------------------------------------------------------------
# checkpoint file loading
# ---------------------------------------------------------------------------


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A .pth / .pt / .safetensors checkpoint -> {key: np.ndarray}, an
    mm-style {'state_dict': ...} / {'model': ...} container unwrapped and a
    DDP 'module.' prefix stripped."""
    if path.endswith(".safetensors"):
        sd = {k: v.numpy() for k, v in load_file(path).items()}
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        for container in ("state_dict", "model", "ema_state_dict"):
            if isinstance(obj, dict) and isinstance(obj.get(container), dict):
                obj = obj[container]
                break
        sd = {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
              for k, v in obj.items() if hasattr(v, "shape")}
    return {k[len("module."):] if k.startswith("module.") else k: np.asarray(v)
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# per-family mm-key -> flax-module-path mappers
# ---------------------------------------------------------------------------


def _resnet_path(mods: List[str]) -> Path:
    """torchvision/mmdet ResNet module list -> the flax backbone path
    (layer1.0 -> layer1_0, downsample.0 -> downsample_0)."""
    out: List[str] = []
    i = 0
    while i < len(mods):
        m = mods[i]
        if m.startswith("layer") and i + 1 < len(mods) and mods[i + 1].isdigit():
            out.append(f"{m}_{mods[i + 1]}")
            i += 2
        elif m == "downsample" and i + 1 < len(mods):
            out.append(f"downsample_{mods[i + 1]}")
            i += 2
        else:
            out.append(m)
            i += 1
    return tuple(out)


def _rpn_roi_path(mods: List[str]) -> Optional[Path]:
    """mmdet RPN + Shared2FC box head names -> the rpn/box_head paths."""
    return {
        "rpn_head.rpn_conv": ("rpn", "rpn_conv"),
        "rpn_head.rpn_cls": ("rpn", "rpn_cls"),
        "rpn_head.rpn_reg": ("rpn", "rpn_reg"),
        "roi_head.bbox_head.shared_fcs.0": ("box_head", "fc1"),
        "roi_head.bbox_head.shared_fcs.1": ("box_head", "fc2"),
        "roi_head.bbox_head.fc_cls": ("box_head", "cls"),
        "roi_head.bbox_head.fc_reg": ("box_head", "reg"),
    }.get(".".join(mods))


def _map_faster_rcnn(mods: List[str]) -> Optional[Path]:
    """mmdet FasterRCNN R50-FPN."""
    if mods[0] == "backbone":
        return ("backbone",) + _resnet_path(mods[1:])
    m = re.fullmatch(r"neck\.lateral_convs\.(\d+)\.conv", ".".join(mods))
    if m:
        return ("fpn", f"lateral_{m.group(1)}")
    m = re.fullmatch(r"neck\.fpn_convs\.(\d+)\.conv", ".".join(mods))
    if m:
        return ("fpn", f"fpn_{m.group(1)}")
    return _rpn_roi_path(mods)


def _csp_inner(rest: List[str], style: str) -> Optional[Path]:
    """mmyolo CSPLayer / CSPLayerWithTwoConv internals -> the C3/C2f names.

    v5 C3:  main_conv->cv1 short_conv->cv2 final_conv->cv3,
            blocks.n.conv1/conv2 -> m_{n}_cv1/m_{n}_cv2
    v8 C2f: main_conv->cv1 final_conv->cv2, blocks.n.conv1/conv2 -> m_{n}/cv1|cv2
    """
    key = ".".join(rest)
    if style == "v5":
        table = {"main_conv": ("cv1",), "short_conv": ("cv2",), "final_conv": ("cv3",)}
    else:
        table = {"main_conv": ("cv1",), "final_conv": ("cv2",)}
    m = re.fullmatch(r"(main_conv|short_conv|final_conv)\.(conv|bn)", key)
    if m and m.group(1) in table:
        return table[m.group(1)] + (m.group(2),)
    m = re.fullmatch(r"blocks\.(\d+)\.(conv1|conv2)\.(conv|bn)", key)
    if m:
        n, cv, sub = m.group(1), "cv1" if m.group(2) == "conv1" else "cv2", m.group(3)
        if style == "v5":
            return (f"m_{n}_{cv}", sub)
        return (f"m_{n}", cv, sub)
    return None


def _map_yolo_backbone(mods: List[str], style: str, csp_name: str) -> Optional[Path]:
    key = ".".join(mods)
    m = re.fullmatch(r"backbone\.stem\.(conv|bn)", key)
    if m:
        return ("stem", m.group(1))
    m = re.fullmatch(r"backbone\.stage(\d)\.0\.(conv|bn)", key)
    if m:
        return (f"down{m.group(1)}", m.group(2))
    m = re.match(r"backbone\.stage(\d)\.1\.(.*)", key)
    if m:
        inner = _csp_inner(m.group(2).split("."), style)
        return (f"{csp_name}_{m.group(1)}",) + inner if inner else None
    m = re.fullmatch(r"backbone\.stage4\.2\.(conv1|conv2)\.(conv|bn)", key)
    if m:
        return ("sppf", "cv1" if m.group(1) == "conv1" else "cv2", m.group(2))
    return None


def _map_yolov5(mods: List[str]) -> Optional[Path]:
    """mmyolo YOLOv5 (CSPDarknet + YOLOv5PAFPN + YOLOv5Head)."""
    p = _map_yolo_backbone(mods, "v5", "c3")
    if p:
        return p
    key = ".".join(mods)
    m = re.fullmatch(r"neck\.reduce_layers\.2\.(conv|bn)", key)
    if m:
        return ("reduce5", m.group(1))
    m = re.match(r"neck\.top_down_layers\.0\.0\.(.*)", key)
    if m:
        inner = _csp_inner(m.group(1).split("."), "v5")
        return ("neck_c3_1",) + inner if inner else None
    m = re.fullmatch(r"neck\.top_down_layers\.0\.1\.(conv|bn)", key)
    if m:
        return ("reduce4", m.group(1))
    m = re.match(r"neck\.top_down_layers\.1\.(.*)", key)
    if m:
        inner = _csp_inner(m.group(1).split("."), "v5")
        return ("neck_c3_2",) + inner if inner else None
    m = re.fullmatch(r"neck\.downsample_layers\.(\d)\.(conv|bn)", key)
    if m:
        return (f"neck_down{3 + int(m.group(1))}", m.group(2))
    m = re.match(r"neck\.bottom_up_layers\.(\d)\.(.*)", key)
    if m:
        inner = _csp_inner(m.group(2).split("."), "v5")
        return (f"neck_c3_{3 + int(m.group(1))}",) + inner if inner else None
    m = re.fullmatch(r"bbox_head\.head_module\.convs_pred\.(\d)", key)
    if m:
        return (f"head_{m.group(1)}",)
    return None


def _map_yolov8(mods: List[str]) -> Optional[Path]:
    """mmyolo YOLOv8 (CSPDarknet-C2f + YOLOv8PAFPN + YOLOv8Head)."""
    p = _map_yolo_backbone(mods, "v8", "c2f")
    if p:
        return p
    key = ".".join(mods)
    td = {"0": "neck_p4", "1": "neck_p3"}
    bu = {"0": "neck_p4b", "1": "neck_p5"}
    m = re.match(r"neck\.top_down_layers\.(\d)\.(.*)", key)
    if m and m.group(1) in td:
        inner = _csp_inner(m.group(2).split("."), "v8")
        return (td[m.group(1)],) + inner if inner else None
    m = re.fullmatch(r"neck\.downsample_layers\.(\d)\.(conv|bn)", key)
    if m:
        return (f"neck_down{3 + int(m.group(1))}", m.group(2))
    m = re.match(r"neck\.bottom_up_layers\.(\d)\.(.*)", key)
    if m and m.group(1) in bu:
        inner = _csp_inner(m.group(2).split("."), "v8")
        return (bu[m.group(1)],) + inner if inner else None
    # head towers: cls_preds.i.{0,1} ConvModules, .2 a plain conv (reg alike)
    m = re.fullmatch(r"bbox_head\.head_module\.(cls|reg)_preds\.(\d)\.([012])(?:\.(conv|bn))?",
                     key)
    if m:
        kind = "cls" if m.group(1) == "cls" else "box"
        base = (f"head_{kind}{int(m.group(3)) + 1}_{m.group(2)}",)
        return base + ((m.group(4),) if m.group(4) else ())
    return None


def _map_vitdet(mods: List[str]) -> Optional[Path]:
    """mmdet ViTDet (ViT-B MAE mask-rcnn): the ViT blocks and the RPN/RoI
    heads, with the block-internal names of mmdet/timm/detectron2 ports
    (ln1|norm1, mlp.fc1|mlp.lin1|ffn.layers.0.0, ...)."""
    key = ".".join(mods)
    if key in ("backbone.patch_embed.projection", "backbone.patch_embed.proj"):
        return ("backbone", "patch_embed")
    if key == "backbone.pos_embed":
        return ("backbone", "pos_embed")
    if key in ("backbone.ln1", "backbone.norm", "backbone.last_norm"):
        return ("backbone", "norm")
    m = re.match(r"backbone\.(?:blocks|layers)\.(\d+)\.(.*)", key)
    if m:
        table = {
            "ln1": "norm1", "norm1": "norm1", "ln2": "norm2", "norm2": "norm2",
            "attn.qkv": "qkv", "attn.proj": "proj",
            "attn.rel_pos_h": "rel_pos_h", "attn.rel_pos_w": "rel_pos_w",
            "mlp.fc1": "fc1", "mlp.lin1": "fc1", "ffn.layers.0.0": "fc1",
            "mlp.fc2": "fc2", "mlp.lin2": "fc2", "ffn.layers.1": "fc2",
        }
        rest = m.group(2)
        return ("backbone", f"block_{m.group(1)}", table[rest]) if rest in table else None
    return _rpn_roi_path(mods)


MAPPERS: Dict[str, Callable[[List[str]], Optional[Path]]] = {
    "faster-rcnn": _map_faster_rcnn,
    "yolov5": _map_yolov5,
    "yolov8": _map_yolov8,
    "vitdet": _map_vitdet,
}


# ---------------------------------------------------------------------------
# tensor conversion
# ---------------------------------------------------------------------------


def _pil_bilinear_f32(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pillow's ``Image.fromarray(img (h, w) f32).resize((out_w, out_h),
    BILINEAR)``: the width pass, then the height pass, float64 sums stored
    as f32 after each."""
    h, w = img.shape
    x = img.astype(np.float32)
    if out_w != w:
        x = (x.astype(np.float64) @ pil_float_matrix(w, out_w)).astype(np.float32)
    if out_h != h:
        x = (pil_float_matrix(h, out_h).T @ x.astype(np.float64)).astype(np.float32)
    return x


def _resize_pos_embed(arr: np.ndarray, target_shape: Tuple[int, ...]) -> np.ndarray:
    """(1, N(+1), C) or (1, h, w, C) pos_embed -> (1, g, g, C), a leading cls
    token dropped and the grid resized bilinearly channel by channel."""
    if arr.ndim == 3:
        n = arr.shape[1]
        g = int(round(n ** 0.5))
        if g * g != n and int(round((n - 1) ** 0.5)) ** 2 == n - 1:
            arr = arr[:, 1:]  # the cls token
            g = int(round((n - 1) ** 0.5))
        arr = arr.reshape(1, g, g, arr.shape[-1])
    tg = target_shape[1]
    if arr.shape[1] != tg:
        c = arr.shape[-1]
        out = np.zeros((1, tg, tg, c), np.float32)
        for ch in range(c):
            out[0, :, :, ch] = _pil_bilinear_f32(arr[0, :, :, ch], tg, tg)
        arr = out
    return arr.astype(np.float32)


# target flax leaves whose torch source is flattened NCHW: (C, H, W) to unpermute
_NCHW_FLATTEN_FC = {("box_head", "fc1", "kernel"): (256, 7, 7)}


@dataclasses.dataclass
class ImportReport:
    imported: List[str] = dataclasses.field(default_factory=list)
    skipped_shape: List[Tuple[str, tuple, tuple]] = dataclasses.field(default_factory=list)
    unmatched: List[str] = dataclasses.field(default_factory=list)
    missing_target: List[str] = dataclasses.field(default_factory=list)
    filled: set = dataclasses.field(default_factory=set)
    params: List[Path] = dataclasses.field(default_factory=list)  # every params leaf

    def coverage(self, prefix: Path) -> float:
        """Fraction of the params leaves under ``prefix`` (a flax path) filled."""
        under = [k for k in self.params if k[:len(prefix)] == prefix]
        if not under:
            return 0.0
        return sum(1 for k in under if ("params",) + k in self.filled) / len(under)


def _convert(arr: np.ndarray, leaf: str, path: Path) -> Tuple[str, Path, np.ndarray]:
    """-> (collection, flax path, value) for a weight/bias/running_* tensor."""
    if leaf == "weight":
        if arr.ndim == 4:
            return "params", path + ("kernel",), arr.transpose(2, 3, 1, 0)
        if arr.ndim == 2:
            spec = _NCHW_FLATTEN_FC.get(path + ("kernel",))
            if spec is not None and arr.shape[1] == int(np.prod(spec)):
                c, fh, fw = spec
                val = arr.reshape(-1, c, fh, fw).transpose(0, 2, 3, 1).reshape(arr.shape[0], -1).T
            else:
                val = arr.T
            return "params", path + ("kernel",), val
        return "params", path + ("scale",), arr  # a norm's gamma
    if leaf == "bias":
        return "params", path + ("bias",), arr
    return "batch_stats", path + (("mean",) if leaf == "running_mean" else ("var",)), arr


def import_detector_weights(family, variables: Dict[str, torch.Tensor],
                            state_dict: Dict[str, np.ndarray], key: str
                            ) -> Tuple[Dict[str, torch.Tensor], ImportReport]:
    """Map an mm checkpoint (``key``: faster-rcnn, yolov5, yolov8, vitdet)
    onto ``family``'s variables (its ``state_dict``). Non-strict: unmatched
    keys and shape-mismatched heads are reported, not fatal (mmengine's
    ``load_from``). -> (new variables, report)."""
    if key not in MAPPERS:
        raise ValueError(f"No importer for family '{key}' (have {sorted(MAPPERS)})")
    mapper = MAPPERS[key]
    flat: Dict[str, Dict[Path, np.ndarray]] = {}
    for name, v in family.to_flax(variables).items():
        col, _, rest = name.partition(".")
        flat.setdefault(col, {})[tuple(rest.split("."))] = v
    report = ImportReport(params=list(flat.get("params", {})))

    for name, arr in state_dict.items():
        arr = np.asarray(arr)
        parts = name.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        special = name.endswith("pos_embed") or leaf in ("rel_pos_h", "rel_pos_w")
        tensor_leaf = leaf in ("weight", "bias", "running_mean", "running_var")
        if not tensor_leaf and not special:
            report.unmatched.append(name)
            continue
        path = mapper(parts[:-1] if tensor_leaf else parts)
        if path is None:
            report.unmatched.append(name)
            continue
        if special:
            col, tpath = "params", path
            tgt = flat.get(col, {}).get(tpath)
            if tgt is None:
                report.missing_target.append(name)
                continue
            if name.endswith("pos_embed"):
                val = _resize_pos_embed(arr, tgt.shape)
            else:  # rel-pos tables: linear interpolation along the length
                val = arr.astype(np.float32)
                if val.shape[0] != tgt.shape[0]:
                    xs = np.linspace(0, val.shape[0] - 1, tgt.shape[0])
                    val = np.stack([np.interp(xs, np.arange(val.shape[0]), val[:, c])
                                    for c in range(val.shape[1])], axis=1)
        else:
            col, tpath, val = _convert(arr, leaf, path)
            tgt = flat.get(col, {}).get(tpath)
            if tgt is None:
                report.missing_target.append(name)
                continue
        if tuple(val.shape) != tuple(tgt.shape):
            report.skipped_shape.append((name, tuple(val.shape), tuple(tgt.shape)))
            continue
        flat[col][tpath] = np.asarray(val, np.float32)
        report.imported.append(name)
        report.filled.add((col,) + tpath)

    new_flat = {f"{col}.{'.'.join(p)}": v for col, d in flat.items() for p, v in d.items()}
    new_vars = {**variables, **family.from_flax(new_flat)}
    logger.info("torch import (%s): %d imported, %d shape-skipped, %d unmatched, "
                "%d missing-target", key, len(report.imported), len(report.skipped_shape),
                len(report.unmatched), len(report.missing_target))
    for k, src, dst in report.skipped_shape[:8]:
        logger.info("  shape-skip %s: ckpt %s vs model %s", k, src, dst)
    return new_vars, report
