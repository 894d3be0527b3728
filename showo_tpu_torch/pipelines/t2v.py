"""Show-o2 text/image-to-video pipeline: flow matching over video latents.

Counterpart of ``showo_tpu/pipelines/t2v.py`` (the reference's video
branches of modeling_showo2_qwen2_5.py and t2i_generate with
first_frame_as_cond for i2v): the cond and null prompt layouts of
``prepare_gen_input`` around one video span (``bov`` / ``eov`` /
``vid_pad``, or the image markers where the tokenizer has none), z ~ N(0, 1)
over [C, T, h, w] latents, CFG by doubling the batch, Euler over the
time-shifted grid, and the Wan2.1 VAE's video decode of the cond half.

For i2v the given first frame is encoded (its posterior noise drawn from
the same generator, after z) and written into z's first latent frame; its
velocity is zero in every evaluation, while t stays one value a row, as
the JAX code does (its docstring's "forced clean" t is not what it runs).

The sequence is cut at the span's end rounded up to 128, and the attention
inputs are made once a generate, both by ``pipelines/t2i_v2.py``'s
helpers.  ``attn_impl="auto"`` picks as JAX's ``_pick_impl``: ``dense``
under 512 video tokens, then ``packed`` (kernel 1 in every layer of both
towers) up to L = 2816 rows and ``streaming`` (kernel 5) above.
``vae_mode="auto"`` decodes the whole clip below
``vae_streaming_min_frames`` latent frames and streams it from there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from showo_tpu_torch.pipelines.t2i_v2 import attention_inputs, cut_at_span
from showo_tpu_torch.show_o2.formats import prepare_gen_input
from showo_tpu_torch.show_o2.qwen2 import check_route
from showo_tpu_torch.show_o2.showo2 import (Showo2, fuse_inference,
                                            showo2_t2i_velocity)
from showo_tpu_torch.show_o2.transport import ode_timegrid, sample_ode_euler
from showo_tpu_torch.show_o2.wan_vae import (WanVAE, wan_decode,
                                             wan_decode_streaming, wan_encode)

# the packed kernel's longest sequence before ``auto`` streams (JAX's
# cut-over, sized for a TPU core's VMEM; kept because both kernels compute
# one function)
PACKED_MAX_ROWS = 2816
VAE_MODES = ("auto", "full", "streaming")


def route_video_attention(attn_impl: str, num_video_tokens: int,
                          rows: int) -> str:
    """``auto``: ``dense`` under 512 video tokens, ``packed`` up to
    :data:`PACKED_MAX_ROWS` rows, ``streaming`` above (JAX
    ``T2VPipeline._pick_impl``); any other name must be a route of
    ``qwen2.ATTN_ROUTES``."""
    if attn_impl != "auto":
        return check_route(attn_impl)
    if num_video_tokens < 512:
        return "dense"
    return "packed" if rows <= PACKED_MAX_ROWS else "streaming"


@dataclasses.dataclass
class T2VPipeline:
    model: Showo2
    vae: WanVAE
    tokenizer: object
    token_ids: dict    # as T2IV2Pipeline's, and bov_id / eov_id / vid_pad_id
    num_latent_frames: int = 5     # 4 (T - 1) + 1 = 17 pixel frames
    guidance_scale: float = 5.0
    num_steps: int = 50
    time_shifting_factor: float = 3.0
    max_text_len: int = 256
    attn_impl: str = "auto"        # auto | dense | packed | streaming
    vae_mode: str = "auto"         # auto | full | streaming
    vae_streaming_min_frames: int = 9   # latent frames

    def __post_init__(self):
        # inference-only weight re-layout (in place), as the JAX default
        fuse_inference(self.model)
        self.cfg = self.model.cfg
        if self.vae_mode not in VAE_MODES:
            raise ValueError(f"unknown vae_mode {self.vae_mode!r}; "
                             f"one of {VAE_MODES}")
        if self.attn_impl != "auto":
            check_route(self.attn_impl)
        self.t_grid = ode_timegrid(
            self.num_steps, time_shifting_factor=self.time_shifting_factor)

    @property
    def device(self) -> torch.device:
        return self.model.showo.model.embed_tokens.weight.device

    @property
    def num_video_tokens(self) -> int:
        cfg = self.cfg
        per = ((cfg.image_latent_height // cfg.patch_size)
               * (cfg.image_latent_width // cfg.patch_size))
        return (self.num_latent_frames * per
                + (1 if cfg.add_time_embeds else 0))

    @property
    def streams_vae(self) -> bool:
        """Whether the decode streams (``vae_mode``, and under ``auto``
        from ``vae_streaming_min_frames`` latent frames on)."""
        return (self.vae_mode == "streaming"
                or (self.vae_mode == "auto" and self.num_latent_frames
                    >= self.vae_streaming_min_frames))

    def build_inputs(self, prompts: Sequence[str]):
        """(text [B', L], modality_positions [B', 1, 2]) of the [cond;
        null] rows around one video span each, cut at the span's end
        rounded up to 128."""
        ids = self.token_ids
        return cut_at_span(*prepare_gen_input(
            list(prompts), self.tokenizer, self.num_video_tokens,
            ids["bos_id"], ids["eos_id"], ids.get("bov_id", ids["boi_id"]),
            ids.get("eov_id", ids["eoi_id"]), ids["pad_id"],
            ids.get("vid_pad_id", ids["img_pad_id"]), self.max_text_len),
            self.guidance_scale, self.device)

    def route(self, rows: int) -> str:
        """The attention route of a generate over ``rows`` rows."""
        return route_video_attention(self.attn_impl, self.num_video_tokens,
                                     rows)

    @torch.no_grad()
    def encode_first_frame(self, first_frame_nhwc: np.ndarray, batch: int,
                           generator: Optional[torch.Generator] = None,
                           eps=None) -> torch.Tensor:
        """One image [H, W, 3] in [-1, 1] -> its latent frame [batch, C, 1,
        h, w] (fp32): the VAE encoder's reparameterised sample, its normal
        draw ``eps`` [batch, C, 1, h, w] or one from ``generator``."""
        vae_dtype = next(self.vae.parameters()).dtype
        pix = torch.as_tensor(np.asarray(first_frame_nhwc, np.float32),
                              device=self.device).permute(2, 0, 1)
        pix = pix[None, :, None].expand(batch, -1, -1, -1, -1)
        return wan_encode(self.vae, pix.to(vae_dtype), generator,
                          eps).float()

    @torch.no_grad()
    def generate_latents(self, prompts: Sequence[str],
                         generator: Optional[torch.Generator] = None,
                         first_frame_nhwc: Optional[np.ndarray] = None,
                         noise=None, first_frame_eps=None) -> torch.Tensor:
        """Denoised video latents [B, C, T, h, w] fp32 of the cond half.  z
        is drawn from ``generator`` or taken from ``noise`` (the tests'
        injected z); ``first_frame_nhwc`` switches to i2v, its encoder
        noise ``first_frame_eps`` or drawn from ``generator``."""
        cfg = self.cfg
        B = len(prompts)
        shape = (B, cfg.image_latent_dim, self.num_latent_frames,
                 cfg.image_latent_height, cfg.image_latent_width)
        if noise is None:
            z = torch.randn(shape, generator=generator, device=self.device)
        else:
            z = torch.as_tensor(noise, dtype=torch.float32,
                                device=self.device)
            if tuple(z.shape) != shape:
                raise ValueError(f"noise must be {shape}, got "
                                 f"{tuple(z.shape)}")
        i2v = first_frame_nhwc is not None
        if i2v:
            frame0 = self.encode_first_frame(first_frame_nhwc, B, generator,
                                             first_frame_eps)
            z = torch.cat([frame0, z[:, :, 1:]], dim=2)
        text, mp = self.build_inputs(prompts)
        if self.guidance_scale > 0:
            z = torch.cat([z, z], dim=0)
        bias, attn_meta = attention_inputs(self.route(text.shape[1]), text,
                                           mp)

        def drift(x, t):
            return showo2_t2i_velocity(
                self.model, text, x, t, bias, mp,
                guidance_scale=self.guidance_scale,
                first_frame_as_cond=i2v,
                num_frames=self.num_latent_frames, attn_meta=attn_meta)

        return sample_ode_euler(drift, z, self.t_grid)[:B]

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """Video latents [B, C, T, h, w] -> frames [B, T_pix, H, W, 3]
        float32 (the VAE in its own dtype, fp32 as built; streamed as
        :attr:`streams_vae` says)."""
        decode = wan_decode_streaming if self.streams_vae else wan_decode
        videos = decode(self.vae, latents.to(self.vae.conv2.weight.dtype))
        return videos.permute(0, 2, 3, 4, 1).float().cpu().numpy()

    def generate(self, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None,
                 first_frame_nhwc: Optional[np.ndarray] = None,
                 noise=None, first_frame_eps=None) -> np.ndarray:
        """Frames [B, T_pix, H, W, 3] in [-1, 1], one video per prompt;
        ``first_frame_nhwc`` ([H, W, 3]) makes it image-to-video."""
        return self.decode(self.generate_latents(
            prompts, generator, first_frame_nhwc, noise, first_frame_eps))
