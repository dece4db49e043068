"""Weight bridge: flax variables (numpy arrays) -> the port's state dicts.

The port's own copy of the layout rules of the JAX package's exporter
(interop/torch_export.py), so weights trained with the JAX package load
into the port with `load_state_dict(strict=True)`:

  Conv2d      kernel (kh,kw,I,O) -> weight (O,I,kh,kw)
  ConvTranspose2d  kernel (kh,kw,I,O) -> weight (I,O,kh,kw), spatially
              flipped (flax's ConvTranspose does not flip its kernel)
  Linear      kernel (I,O)       -> weight (O,I); after a conv map (the
              classifiers' and the encoder-decoder's fc) its inputs go from
              flax's (H,W,C) flatten order to torch's (C,H,W); before one
              (the encoder-decoder's decoder.fc1) its outputs and bias do
  Group/LayerNorm, BatchNorm  scale/bias -> weight/bias
  BatchNorm   batch_stats mean/var -> running_mean/running_var, and
              num_batches_tracked = 0 (inference never reads it)

`variables` is {'params': ...} (plus 'batch_stats' for BatchNorm models) or
a bare params tree; leaves are anything `np.asarray` accepts.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C"))     # an owned copy


def _conv(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{name}.bias"] = _t(p["bias"])


def _dense(out: StateDict, name: str, p: Mapping[str, Any],
           conv_shape=None) -> None:
    w = np.asarray(p["kernel"]).T                 # (O, I)
    if conv_shape is not None:                    # I flattened (H, W, C)
        c, h, ww = conv_shape
        w = w.reshape(-1, h, ww, c).transpose(0, 3, 1, 2).reshape(
            w.shape[0], -1)
    out[f"{name}.weight"] = _t(w)
    out[f"{name}.bias"] = _t(p["bias"])


def _deconv(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    k = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    out[f"{name}.weight"] = _t(k)
    out[f"{name}.bias"] = _t(p["bias"])


def _dense_spatial_out(out: StateDict, name: str, p: Mapping[str, Any],
                       out_shape) -> None:
    """Linear whose output is reshaped to a (C, H, W) map: flax's rows are
    in (H, W, C) order."""
    c, h, ww = out_shape
    w = np.asarray(p["kernel"]).T                 # (H*W*C, I)
    w = w.reshape(h, ww, c, -1).transpose(2, 0, 1, 3).reshape(c * h * ww, -1)
    b = np.asarray(p["bias"]).reshape(h, ww, c).transpose(2, 0, 1)
    out[f"{name}.weight"] = _t(w)
    out[f"{name}.bias"] = _t(b.reshape(-1))


def _norm(out: StateDict, name: str, p: Mapping[str, Any]) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _bn(out: StateDict, name: str, p: Mapping[str, Any],
        stats: Mapping[str, Any]) -> None:
    _norm(out, name, p)
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _resblock(out: StateDict, prefix: str, p: Mapping[str, Any]) -> None:
    _norm(out, f"{prefix}.norm1", p["GroupNorm_0"])
    _conv(out, f"{prefix}.conv1", p["conv1"])
    _dense(out, f"{prefix}.time_mlp.1", p["time_mlp"])
    _norm(out, f"{prefix}.norm2", p["GroupNorm_1"])
    _conv(out, f"{prefix}.conv2", p["conv2"])
    if "skip" in p:
        _conv(out, f"{prefix}.skip", p["skip"])


def unet_state_dict(variables: Mapping[str, Any], channel_mult=(1, 2),
                    num_res_blocks: int = 2) -> StateDict:
    """FlexibleUNet params -> models.unet.FlexibleUNet state dict."""
    p = variables["params"]
    out: StateDict = {}
    _dense(out, "time_embed.0", p["time_dense1"])
    _dense(out, "time_embed.2", p["time_dense2"])
    _conv(out, "input_conv", p["input_conv"])
    n_levels = len(channel_mult)
    for i in range(n_levels * num_res_blocks):
        _resblock(out, f"encoder_blocks.{i}", p[f"enc_{i}"])
    for lvl in range(n_levels - 1):
        _conv(out, f"downsamplers.{lvl}.conv", p[f"down_{lvl}"]["conv"])
        _conv(out, f"upsamplers.{lvl}.conv", p[f"up_{lvl}"]["conv"])
    _resblock(out, "middle_block1", p["middle_1"])
    _resblock(out, "middle_block2", p["middle_2"])
    for i in range(n_levels * (num_res_blocks + 1)):
        _resblock(out, f"decoder_blocks.{i}", p[f"dec_{i}"])
    _norm(out, "out_norm", p["GroupNorm_0"])
    _conv(out, "out_conv", p["out_conv"])
    return out


def flow_matching_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """FlowMatchingModel params -> models.flow_matching.FlowMatchingModel
    state dict (`--model original`)."""
    p = variables["params"]
    out: StateDict = {}
    enc, dec = p["encoder"], p["decoder"]
    for i in range(1, 5):
        _conv(out, f"encoder.conv{i}", enc[f"conv{i}"])
        _norm(out, f"encoder.gn{i}", enc[f"gn{i}"])
    _dense(out, "encoder.fc", enc["fc"], (256, 7, 7))
    _dense_spatial_out(out, "decoder.fc1", dec["fc1"], (256, 7, 7))
    _deconv(out, "decoder.deconv1", dec["deconv1"])
    _deconv(out, "decoder.deconv2", dec["deconv2"])
    _conv(out, "decoder.conv3", dec["conv3"])
    _conv(out, "decoder.conv_out", dec["conv_out"])
    for i in range(1, 4):
        _norm(out, f"decoder.gn{i}", dec[f"gn{i}"])
    return out


def ratio_gn_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """FlexibleRatioEstimator params -> port state dict (experiment 1)."""
    p = variables["params"]
    out: StateDict = {}
    for enc in ("encoder_x", "encoder_y"):
        for i in range(1, 5):
            _conv(out, f"{enc}.conv{i}", p[enc][f"conv{i}"])
            _norm(out, f"{enc}.gn{i}", p[enc][f"gn{i}"])
        _dense(out, f"{enc}.fc", p[enc]["fc"])
    s = p["score_net"]
    for idx, name in ((0, "fc1"), (4, "fc2"), (8, "fc3")):
        _dense(out, f"score_net.{idx}", s[name])
    for idx, name in ((1, "ln1"), (5, "ln2")):
        _norm(out, f"score_net.{idx}", s[name])
    return out


def _bn_encoder(out: StateDict, prefix: str, p: Mapping[str, Any],
                stats: Mapping[str, Any], convs) -> None:
    for c in convs:
        _conv(out, f"{prefix}.conv{c}", p[f"conv{c}"])
        _bn(out, f"{prefix}.bn{c}", p[f"bn{c}"], stats[f"bn{c}"])
    _dense(out, f"{prefix}.fc", p["fc"])


def ratio_mnist_svhn_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """RatioEstimatorMNISTSVHN params + batch_stats -> port state dict."""
    p, st = variables["params"], variables["batch_stats"]
    out: StateDict = {}
    _bn_encoder(out, "encoder_mnist", p["encoder_mnist"],
                st["encoder_mnist"], ["1", "2", "3", "4"])
    _bn_encoder(out, "encoder_svhn", p["encoder_svhn"], st["encoder_svhn"],
                ["1a", "1b", "2a", "2b", "3a", "3b", "4a", "4b"])
    s = p["score_net"]
    for idx, name in ((0, "fc1"), (4, "fc2"), (8, "fc3"), (11, "fc4")):
        _dense(out, f"score_net.{idx}", s[name])
    for idx, name in ((1, "ln1"), (5, "ln2"), (9, "ln3")):
        _norm(out, f"score_net.{idx}", s[name])
    return out


def classifier_state_dict(variables: Mapping[str, Any], n_convs: int,
                          conv_shape, batch_norm: bool = False) -> StateDict:
    """MNISTClassifier / MNISTClassifier32 / SVHNClassifier params (+
    batch_stats) -> models.classifiers state dict."""
    p = variables["params"]
    out: StateDict = {}
    for i in range(1, n_convs + 1):
        _conv(out, f"conv{i}", p[f"conv{i}"])
        if batch_norm:
            _bn(out, f"bn{i}", p[f"bn{i}"], variables["batch_stats"][f"bn{i}"])
    _dense(out, "fc1", p["fc1"], conv_shape)
    _dense(out, "fc2", p["fc2"])
    return out


BRIDGES = {
    "unet_mnist": lambda v: unet_state_dict(v, channel_mult=(1, 2)),
    "unet_svhn": lambda v: unet_state_dict(v, channel_mult=(1, 2, 2)),
    "unet_64": lambda v: unet_state_dict(v, channel_mult=(1, 2, 2, 4)),
    "fm_original": flow_matching_state_dict,
    "ratio_mnist": ratio_gn_state_dict,
    "ratio_mnist_svhn": ratio_mnist_svhn_state_dict,
    "classifier_mnist": lambda v: classifier_state_dict(v, 2, (64, 7, 7)),
    "classifier_mnist32": lambda v: classifier_state_dict(v, 3, (64, 8, 8)),
    "classifier_svhn": lambda v: classifier_state_dict(v, 4, (128, 8, 8),
                                                       batch_norm=True),
    "classifier_64": lambda v: classifier_state_dict(v, 3, (64, 8, 8)),
}
BATCH_NORM_MODELS = ("ratio_mnist_svhn", "classifier_svhn")


def state_dict_from_jax(variables: Mapping[str, Any], model: str) -> StateDict:
    """Convert flax variables of `model` (a key of BRIDGES: 'unet_mnist',
    'unet_svhn', 'unet_64', 'fm_original', 'ratio_mnist',
    'ratio_mnist_svhn', 'classifier_mnist', 'classifier_mnist32',
    'classifier_svhn', 'classifier_64') into the port's state dict."""
    if model not in BRIDGES:
        raise ValueError(f"unknown model kind {model!r}; one of "
                         f"{sorted(BRIDGES)}")
    if "params" not in variables:
        variables = {"params": variables}
    if model in BATCH_NORM_MODELS and "batch_stats" not in variables:
        raise ValueError(f"{model} uses BatchNorm: pass variables with "
                         "'batch_stats' alongside 'params'")
    return BRIDGES[model](variables)
