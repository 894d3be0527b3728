"""Weights between the JAX package, the reference layout and the port.

The port's modules carry the reference checkpoint's tensor names, so the
common currency is a reference-layout state dict ({name: array}):

  * Phi / Show-o: JAX params -> ``showo_tpu.utils.torch_export.phi_state_dict``
    -> :func:`load_showo`;
  * MAGVIT-v2: flax params -> :func:`magvit_state_dict` (the exact inverse
    of ``showo_tpu.utils.torch_import.magvit_params_from_torch``: HWIO ->
    OIHW convs, GroupNorm scale/bias -> weight/bias) -> :func:`load_magvit`.

Real checkpoints (``showlab/show-o-512x512``, ``showlab/magvitv2``) are
reference-layout already and load through :func:`load_reference_weights`.
Everything here is numpy on the JAX side; nothing imports jax or the JAX
package (the parity tests feed it the JAX package's trees).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from showo_tpu_torch.models.magvit import VQConfig


def _load_file(path: str) -> Dict[str, np.ndarray]:
    """One ``.safetensors`` or ``torch.save`` checkpoint file as numpy
    arrays (floating tensors in fp32)."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return dict(load_file(path))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() if v.dtype.is_floating_point else v.numpy()
            for k, v in sd.items()}


def load_reference_weights(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file, or a directory of ``.safetensors`` / ``.bin`` /
    ``.pth`` shards, as {name: np.ndarray}."""
    if not os.path.isdir(path):
        return _load_file(path)
    sd: Dict[str, np.ndarray] = {}
    for f in sorted(os.listdir(path)):
        if f.endswith((".safetensors", ".bin", ".pth")):
            sd.update(_load_file(os.path.join(path, f)))
    return sd


def _load(model: torch.nn.Module, sd: Mapping[str, np.ndarray]):
    """Copy every tensor of ``model`` from the same-named entry of ``sd``
    (in the model's dtype and device); other entries are ignored."""
    p = next(model.parameters())
    want = model.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} of the model's "
                       f"tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: torch.tensor(np.asarray(sd[k]),
                                           dtype=p.dtype, device=p.device)
                           for k in want}, strict=True)
    return model


def load_showo(model: torch.nn.Module, sd: Mapping[str, np.ndarray]):
    """Load a reference Show-o state dict (``showo.model.layers...``) into a
    not yet fused :class:`~showo_tpu_torch.models.showo.Showo`."""
    return _load(model, sd)


def load_magvit(model: torch.nn.Module, sd: Mapping[str, np.ndarray]):
    """Load a reference MAGVIT-v2 state dict (``encoder.*`` and
    ``decoder.*``) into a :class:`~showo_tpu_torch.models.magvit.MagvitV2`;
    other entries (the reference's quantizer buffers) are ignored."""
    return _load(model, sd)


# ---------------------------------------------------------------------------
# MAGVIT-v2: flax params -> reference layout
# ---------------------------------------------------------------------------

def _conv(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = np.transpose(np.asarray(node["kernel"]),
                                        (3, 2, 0, 1))
    sd[f"{name}.bias"] = np.asarray(node["bias"])


def _norm(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = np.asarray(node["scale"])
    sd[f"{name}.bias"] = np.asarray(node["bias"])


def _resblock(sd: dict, name: str, node: Mapping) -> None:
    _norm(sd, f"{name}.norm1", node["norm1"])
    _conv(sd, f"{name}.conv1", node["conv1"])
    _norm(sd, f"{name}.norm2", node["norm2"])
    _conv(sd, f"{name}.conv2", node["conv2"])
    if "nin_shortcut" in node:
        _conv(sd, f"{name}.nin_shortcut", node["nin_shortcut"])


def _mid(sd: dict, name: str, tree: Mapping) -> None:
    _resblock(sd, f"{name}.block_1", tree["mid_block_1"])
    _norm(sd, f"{name}.attn_1.norm", tree["mid_attn_1"]["norm"])
    for p in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{name}.attn_1.{p}", tree["mid_attn_1"][p])
    _resblock(sd, f"{name}.block_2", tree["mid_block_2"])


def magvit_state_dict(params: Mapping,
                      cfg: VQConfig = VQConfig()) -> Dict[str, np.ndarray]:
    """flax MagvitV2 params ({"encoder", "decoder"}) -> reference-layout
    state dict; inverse of ``magvit_params_from_torch``."""
    sd: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    n = len(cfg.enc_ch_mult)
    for i in range(n):
        for j in range(cfg.enc_num_res_blocks[i]):
            _resblock(sd, f"encoder.down.{i}.block.{j}",
                      enc[f"down_{i}_block_{j}"])
        if i != n - 1:
            _conv(sd, f"encoder.down.{i}.downsample.conv",
                  enc[f"down_{i}_downsample"]["conv"])
    _mid(sd, "encoder.mid", enc)
    _norm(sd, "encoder.norm_out", enc["norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "encoder.quant_conv", enc["quant_conv"])

    dec = params["decoder"]
    _conv(sd, "decoder.post_quant_conv", dec["post_quant_conv"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _mid(sd, "decoder.mid", dec)
    for i in range(len(cfg.dec_ch_mult)):
        for j in range(cfg.dec_num_res_blocks[i]):
            _resblock(sd, f"decoder.up.{i}.block.{j}",
                      dec[f"up_{i}_block_{j}"])
        if i != 0:
            _conv(sd, f"decoder.up.{i}.upsample.conv",
                  dec[f"up_{i}_upsample"]["conv"])
    _norm(sd, "decoder.norm_out", dec["norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    return sd
