"""Weights between the JAX package, the reference layout and the port.

The port's modules carry the reference checkpoint's tensor names, so the
common currency is a reference-layout state dict ({name: array}):

  * Phi / Show-o: JAX params -> ``showo_tpu.utils.torch_export.phi_state_dict``
    -> :func:`load_showo`;
  * MAGVIT-v2: flax params -> :func:`magvit_state_dict` (the exact inverse
    of ``showo_tpu.utils.torch_import.magvit_params_from_torch``: HWIO ->
    OIHW convs, GroupNorm scale/bias -> weight/bias) -> :func:`load_magvit`;
  * CLIP-ViT: JAX params -> :func:`clip_vit_state_dict` (the inverse of
    ``clip_vit_params_from_torch``, HF ``vision_model.*`` names) ->
    :func:`load_clip_vit`; the Show-o ``mm_projector`` travels in the
    Show-o state dict (``mm_projector.0`` / ``mm_projector.2``);
  * int8 serving params (JAX ``quantize_int8``: ``kernel_i8`` [K, N],
    ``scale`` [1, N]) -> :func:`load_int8_params` into the ``Int8Linear``
    buffers of a quantized port Phi, :func:`load_qwen2_int8_params` of a
    quantized port Qwen2;
  * Show-o2: JAX params -> ``showo_tpu.utils.torch_export.showo2_state_dict``
    -> :func:`load_showo2`;
  * Wan2.1 VAE: JAX params -> :func:`wan_vae_state_dict` (the inverse of
    ``wan_vae_params_from_torch``: DHWIO / HWIO -> OIDHW / OIHW
    convolutions, flat gammas -> the reference's [C, 1, 1(, 1)]) ->
    :func:`load_wan_vae`.

Real checkpoints (``showlab/show-o-512x512``, ``showlab/magvitv2``,
``showlab/show-o2-1.5B``, ``Wan2.1_VAE.pth``) are reference-layout already
and load through :func:`load_reference_weights`.
Everything here is numpy on the JAX side; nothing imports jax or the JAX
package (the parity tests feed it the JAX package's trees).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from showo_tpu_torch.models.magvit import VQConfig
from showo_tpu_torch.show_o2.wan_vae import (WanVAEConfig, decoder_structure,
                                             encoder_structure)


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


def load_clip_vit(model: torch.nn.Module, sd: Mapping[str, np.ndarray]):
    """Load an HF ``CLIPVisionModel`` state dict (``vision_model.*``) into a
    :class:`~showo_tpu_torch.models.clip_vit.ClipVisionTower`; other
    entries (``post_layernorm``, a text tower) are ignored."""
    return _load(model, sd)


def load_showo2(model: torch.nn.Module, sd: Mapping[str, np.ndarray]):
    """Load a reference Show-o2 state dict (``showo.model.layers...``,
    ``und_trans.layers...``, ``diffusion_head_a.{i}...``; with an untied
    Qwen2, as the 7B's, ``showo.lm_head.weight`` too) into a not yet
    fused :class:`~showo_tpu_torch.show_o2.showo2.Showo2`."""
    return _load(model, sd)


def load_wan_vae(model: torch.nn.Module, sd: Mapping[str, np.ndarray]):
    """Load a Wan2.1 VAE state dict (encoder, ``conv1``, ``conv2`` and
    decoder) into a :class:`~showo_tpu_torch.show_o2.wan_vae.WanVAE`."""
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


# ---------------------------------------------------------------------------
# CLIP-ViT: JAX params -> HF layout
# ---------------------------------------------------------------------------

def clip_vit_state_dict(params: Mapping, num_layers: int,
                        prefix: str = "vision_model.") -> Dict[str, np.ndarray]:
    """JAX CLIP-ViT params (stacked layers) -> HF ``CLIPVisionModel`` state
    dict; inverse of ``clip_vit_params_from_torch``: HWIO -> OIHW patch
    conv, [K, N] -> [N, K] linears, LayerNorm scale -> weight."""
    sd: Dict[str, np.ndarray] = {}
    e = f"{prefix}embeddings."
    sd[f"{e}patch_embedding.weight"] = np.transpose(
        np.asarray(params["patch_embed"]["kernel"]), (3, 2, 0, 1))
    sd[f"{e}class_embedding"] = np.asarray(params["class_embed"])
    sd[f"{e}position_embedding.weight"] = np.asarray(params["pos_embed"])
    _norm(sd, f"{prefix}pre_layrnorm", params["pre_ln"])
    L = params["layers"]
    names = {"ln1": "layer_norm1", "ln2": "layer_norm2",
             "q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "out": "self_attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(num_layers):
        base = f"{prefix}encoder.layers.{i}"
        for ours, theirs in names.items():
            node = {k: np.asarray(v)[i] for k, v in L[ours].items()}
            if "kernel" in node:
                sd[f"{base}.{theirs}.weight"] = node["kernel"].T
                sd[f"{base}.{theirs}.bias"] = node["bias"]
            else:
                _norm(sd, f"{base}.{theirs}", node)
    return sd


# ---------------------------------------------------------------------------
# Wan2.1 VAE: JAX params -> reference layout
# ---------------------------------------------------------------------------

def wan_vae_state_dict(params: Mapping,
                       cfg: WanVAEConfig = WanVAEConfig()
                       ) -> Dict[str, np.ndarray]:
    """JAX Wan2.1 VAE params ({"encoder", "conv1", "conv2", "decoder"}) ->
    the reference ``Wan2.1_VAE.pth`` state dict; the inverse of
    ``wan_vae_params_from_torch``."""
    sd: Dict[str, np.ndarray] = {}

    def conv(name, node):
        k = np.asarray(node["kernel"])
        perm = (4, 3, 0, 1, 2) if k.ndim == 5 else (3, 2, 0, 1)
        sd[f"{name}.weight"] = np.transpose(k, perm)
        sd[f"{name}.bias"] = np.asarray(node["bias"])

    def gamma(name, node, images=False):
        g = np.asarray(node["gamma"]).reshape(-1)
        sd[f"{name}.gamma"] = g.reshape((-1, 1, 1) if images
                                        else (-1, 1, 1, 1))

    def res(prefix, node):
        gamma(f"{prefix}.residual.0", node["norm1"])
        conv(f"{prefix}.residual.2", node["conv1"])
        gamma(f"{prefix}.residual.3", node["norm2"])
        conv(f"{prefix}.residual.6", node["conv2"])
        if "shortcut" in node:
            conv(f"{prefix}.shortcut", node["shortcut"])

    def stack(side, tree, plan, seq_name):
        conv(f"{side}.conv1", tree["conv1"])
        for idx, (kind, _) in enumerate(plan):
            pref, node = f"{side}.{seq_name}.{idx}", tree[f"b{idx}"]
            if kind == "res":
                res(pref, node)
            else:
                conv(f"{pref}.resample.1", node["conv"])
                if "time" in node:
                    conv(f"{pref}.time_conv", node["time"])
        res(f"{side}.middle.0", tree["mid_res1"])
        attn = tree["mid_attn"]
        gamma(f"{side}.middle.1.norm", attn["norm"], images=True)
        conv(f"{side}.middle.1.to_qkv", attn["to_qkv"])
        conv(f"{side}.middle.1.proj", attn["proj"])
        res(f"{side}.middle.2", tree["mid_res2"])
        gamma(f"{side}.head.0", tree["head_norm"])
        conv(f"{side}.head.2", tree["head_conv"])

    stack("encoder", params["encoder"], encoder_structure(cfg), "downsamples")
    conv("conv1", params["conv1"])
    conv("conv2", params["conv2"])
    stack("decoder", params["decoder"], decoder_structure(cfg), "upsamples")
    return sd


# ---------------------------------------------------------------------------
# int8 serving params: JAX quantize_int8 -> Int8Linear buffers
# ---------------------------------------------------------------------------

def _put_int8(module, node, i=None):
    """Copy one JAX int8 node (``kernel_i8``, ``scale``, maybe ``bias``;
    layer ``i`` of stacked arrays) into an ``Int8Linear``."""
    from showo_tpu_torch.models.phi import Int8Linear

    if not isinstance(module, Int8Linear):
        raise TypeError(f"{type(module).__name__} is not quantized; run "
                        f"quantize_int8 on the port model first")
    pick = (lambda a: np.asarray(a)) if i is None else (
        lambda a: np.asarray(a)[i])
    bias = node.get("bias")
    module.load_quantized(pick(node["kernel_i8"]), pick(node["scale"]),
                          None if bias is None else pick(bias))


def load_int8_params(phi: torch.nn.Module, params: Mapping):
    """Copy JAX ``quantize_int8`` params (a Phi tree whose quantized
    matmuls hold stacked ``kernel_i8`` [L, K, N], ``scale`` [L, 1, N] and
    ``bias`` [L, N], and ``lm_head``) into the ``Int8Linear`` modules of a
    port Phi already fused and quantized to the same layout."""
    from showo_tpu_torch.models.phi import INT8_LINEARS

    return _load_int8_layers(phi, params, INT8_LINEARS)


def load_qwen2_int8_params(qwen: torch.nn.Module, params: Mapping):
    """Copy JAX Qwen2 ``quantize_int8`` params (the ``showo`` tree: stacked
    ``kernel_i8`` [L, K, N] and ``scale`` [L, 1, N] of each quantized
    matmul, ``bias`` [L, N] of q / k / v or qkv, and ``lm_head``) into the
    ``Int8Linear`` modules of a port Qwen2 fused (or not) and quantized to
    the same layout."""
    from showo_tpu_torch.show_o2.qwen2 import INT8_LINEARS

    return _load_int8_layers(qwen, params, INT8_LINEARS)


def _load_int8_layers(model: torch.nn.Module, params: Mapping,
                      paths: Mapping[str, str]):
    """Every quantized node of ``params["layers"]`` named in ``paths``
    (JAX name -> module path in a layer), then ``lm_head``."""
    for name, path in paths.items():
        node = params["layers"].get(name)
        if node is None or "kernel_i8" not in node:
            continue
        for i, layer in enumerate(model.model.layers):
            _put_int8(layer.get_submodule(path), node, i)
    _put_int8(model.lm_head, params["lm_head"])
    return model
