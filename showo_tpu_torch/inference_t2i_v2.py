"""CLI entry: Show-o2 text-to-image (flow matching) on PyTorch.

    python -m showo_tpu_torch.inference_t2i_v2 \
        config=configs/showo2_1.5b_demo_432x432.yaml batch_size=4

Counterpart of ``showo_tpu/inference_t2i_v2.py``.  Weights:
``model.showo.pretrained_model_path`` and
``model.vae_model.pretrained_model_path`` are loaded when they exist
locally as reference checkpoints (file or directory); otherwise the
models are random-initialised from fixed seeds.  The tokenizer loads from
a local ``model.showo.llm_model_path`` directory through ``transformers``;
otherwise a word-hash stand-in with the JAX package's fallback ids does.
Prompts come from ``validation_prompts_file`` when it exists, else from
the in-tree ``assets/validation/text2image_prompts.txt``.  Show-o2 runs on
CUDA in bf16 (the kernels' type) and the VAE in fp32, or both in fp32 on
the CPU when the config key ``device=cpu`` asks for it; without a card and
without that key it raises.  ``model.vae_model.dims={...}`` overrides the
VAE's widths for tiny runs (as ``model.showo.siglip`` / ``dit`` do the
towers').  Writes one PNG per prompt into ``output_dir``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch

from showo_tpu_torch.config import get_config
from showo_tpu_torch.pipelines.t2i_v2 import T2IV2Pipeline
from showo_tpu_torch.pipelines.t2v import T2VPipeline
from showo_tpu_torch.show_o2.dit import DiffusionHeadConfig
from showo_tpu_torch.show_o2.qwen2 import Qwen2Config
from showo_tpu_torch.show_o2.showo2 import Showo2, Showo2Config
from showo_tpu_torch.show_o2.siglip import SigLipConfig
from showo_tpu_torch.show_o2.wan_vae import WanVAE, WanVAEConfig
from showo_tpu_torch.utils.assets import validation_prompts_file
from showo_tpu_torch.utils.convert import (load_reference_weights,
                                           load_showo2, load_wan_vae)
from showo_tpu_torch.utils.device import entry_device
from showo_tpu_torch.utils.image import to_pil_images

logger = logging.getLogger(__name__)


QWEN_TOKEN_IDS = {  # qwen2.5 vocab ids (misc.py:371-386)
    "bos_id": 151644,   # <|im_start|>
    "eos_id": 151645,   # <|im_end|>
    "boi_id": 151652,   # <|vision_start|>
    "eoi_id": 151653,   # <|vision_end|>
    "img_pad_id": 151655,  # <|image_pad|>
    "vid_pad_id": 151656,  # <|video_pad|>
    "pad_id": 151936,   # [PAD] (added)
}

# the stand-in tokenizer's special ids (the JAX package's fallback)
FAKE_TOKEN_IDS = dict(bos_id=1, eos_id=2, boi_id=3, eoi_id=4, pad_id=5,
                      img_pad_id=6, vid_pad_id=7)


def build_showo2_config(config) -> Showo2Config:
    """The model's dims from ``model.showo``; ``attn_fp32`` (default true)
    false sets the bf16 softmax of the dense route in Qwen2.5 and the DiT
    (bench.py's ``softmax=bf16``, which the JAX package sets by replacing
    both configs)."""
    m = config.model.showo
    fp32 = bool(m.get("attn_fp32", True))
    llm = Qwen2Config(
        hidden_size=m.hidden_size,
        vocab_size=m.get("llm_vocab_size") or 151940,
        intermediate_size=m.get("llm_intermediate_size", 8960),
        num_layers=m.get("llm_num_layers", 28),
        num_heads=m.get("llm_num_heads", 12),
        num_kv_heads=m.get("llm_num_kv_heads", 2),
        head_dim=m.get("llm_head_dim", 128),
        tie_word_embeddings=m.get("llm_tie_word_embeddings", True),
        attn_fp32=fp32,
    )
    # optional dim-override dicts for tiny runs; defaults = released dims
    sig = {k: int(v) for k, v in dict(m.get("siglip", {})).items()}
    dit_ov = {k: int(v) for k, v in dict(m.get("dit", {})).items()}
    return Showo2Config(
        llm=llm,
        siglip=SigLipConfig(**sig),
        dit=DiffusionHeadConfig(num_layers=m.get("num_diffusion_layers", 10),
                                attn_fp32=fp32, **dit_ov),
        image_latent_dim=m.image_latent_dim,
        image_latent_height=m.image_latent_height,
        image_latent_width=m.image_latent_width,
        patch_size=m.patch_size,
        clip_latent_dim=m.clip_latent_dim,
        add_time_embeds=m.add_time_embeds,
    )


class FakeQwenTokenizer:
    """The word-hash stand-in (``utils/fake_tokenizer.py``) with the call
    that ``prepare_gen_input`` makes: ``tok(text,
    add_special_tokens=False)["input_ids"]`` a flat list; and ``decode`` /
    ``batch_decode``, which give back the words it has encoded (a word it
    has not seen prints as ``<id>``; the special ids of
    :data:`FAKE_TOKEN_IDS` are dropped with ``skip_special_tokens``), so
    that an understanding answer prints as text."""

    def __init__(self):
        from showo_tpu_torch.utils.fake_tokenizer import FakeTokenizer

        self._t = FakeTokenizer()
        self._words: dict = {}

    def __call__(self, text, add_special_tokens=False):
        ids = self._t(text)["input_ids"][0]
        for word, i in zip(text.split(), ids):
            self._words.setdefault(i, word)
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        special = set(FAKE_TOKEN_IDS.values()) if skip_special_tokens else ()
        return " ".join(self._words.get(int(i), f"<{int(i)}>") for i in ids
                        if int(i) not in special)

    def batch_decode(self, seqs, skip_special_tokens: bool = False):
        return [self.decode(s, skip_special_tokens) for s in seqs]


def load_tokenizer_and_ids(config):
    """(tokenizer, special token ids): the Qwen2.5 tokenizer of a local
    ``model.showo.llm_model_path`` directory with Show-o2's added tokens
    through ``show_o2/tokenizer.py::get_text_tokenizer`` with its ids (the
    video and ``<image>`` ones among them), else the stand-in and the JAX
    CLI's fallback ids.  A hub name is never fetched."""
    path = config.model.showo.llm_model_path
    if not os.path.isdir(str(path)):
        logger.warning("tokenizer %s not found locally; using the stand-in "
                       "tokenizer", path)
        return FakeQwenTokenizer(), dict(FAKE_TOKEN_IDS)
    from showo_tpu_torch.show_o2.tokenizer import get_text_tokenizer

    return get_text_tokenizer(str(path), return_showo_token_ids=True)


def load_model(config, cfg: Showo2Config, device, dtype) -> Showo2:
    path = str(config.model.showo.pretrained_model_path)
    if os.path.exists(path):
        logger.info("loading Show-o2 weights from %s", path)
        model = load_showo2(Showo2(cfg, device=device, dtype=dtype),
                            load_reference_weights(path))
    else:
        logger.warning("pretrained_model_path=%s not found; random init",
                       path)
        model = Showo2(cfg, device=device, dtype=dtype).init_random(
            torch.Generator(device=device).manual_seed(0))
    return model.eval().requires_grad_(False)


def vae_config(config) -> WanVAEConfig:
    ov = dict(config.model.vae_model.get("dims", {}))
    return WanVAEConfig(**{k: (tuple(v) if isinstance(v, (list, tuple))
                               else int(v)) for k, v in ov.items()})


def load_vae(config, device) -> WanVAE:
    """The Wan2.1 VAE decoder in fp32 (as the JAX pipeline runs it)."""
    cfg = vae_config(config)
    path = str(config.model.vae_model.pretrained_model_path)
    if os.path.exists(path):
        logger.info("loading Wan2.1 VAE weights from %s", path)
        vae = load_wan_vae(WanVAE(cfg, device=device),
                           load_reference_weights(path))
    else:
        logger.warning("vae_model.pretrained_model_path=%s not found; "
                       "random init", path)
        vae = WanVAE(cfg, device=device).init_random(
            torch.Generator(device=device).manual_seed(1))
    return vae.eval().requires_grad_(False)


def load_models(config, device: torch.device):
    """(Show-o2, Wan2.1 VAE) of the config on ``device``: Show-o2 in bf16 on
    CUDA and fp32 on the CPU, the VAE in fp32; weights loaded or
    random-init (JAX ``load_models``)."""
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return (load_model(config, build_showo2_config(config), device, dtype),
            load_vae(config, device))


def build_pipeline(config, device: Optional[torch.device] = None,
                   attn_impl: str = "auto",
                   prefix_cache: bool = False) -> T2IV2Pipeline:
    """Config -> ready T2IV2Pipeline (weights loaded or random-init).

    device defaults to CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``).  attn_impl: the pipeline's
    attention route (``T2IV2Pipeline.attn_impl``); prefix_cache: the
    prefix-cached velocity (off, as in the JAX CLI, which has no key for
    it).  ``transport.sampling_method`` picks the sampler: euler, heun,
    dpm-solver (dpm) or dopri5."""
    device = entry_device(device)
    tokenizer, token_ids = load_tokenizer_and_ids(config)
    model, vae = load_models(config, device)
    tr = config.transport
    return T2IV2Pipeline(
        model=model, vae=vae, tokenizer=tokenizer, token_ids=token_ids,
        guidance_scale=float(config.get("guidance_scale", 7.5)),
        num_steps=int(tr.get("num_inference_steps", 50)),
        time_shifting_factor=float(tr.get("time_shifting_factor", 3.0)),
        max_text_len=int(config.dataset.preprocessing.get("max_text_len",
                                                          256)),
        sampling_method=str(tr.get("sampling_method", "euler")),
        attn_impl=attn_impl, prefix_cache=prefix_cache)


def build_t2v_pipeline(config, device: Optional[torch.device] = None,
                       **options) -> T2VPipeline:
    """Config -> ready T2VPipeline on this CLI's loaders (the JAX package
    has no text-to-video CLI, so neither has the port).  ``options`` are
    T2VPipeline's fields (num_latent_frames, guidance_scale, num_steps,
    attn_impl, vae_mode, ...); the config gives the time shift and the
    text length."""
    device = entry_device(device)
    tokenizer, token_ids = load_tokenizer_and_ids(config)
    kw = dict(time_shifting_factor=float(config.transport.get(
        "time_shifting_factor", 3.0)), max_text_len=int(
        config.dataset.preprocessing.get("max_text_len", 256)))
    kw.update(options)
    model, vae = load_models(config, device)
    return T2VPipeline(model=model, vae=vae, tokenizer=tokenizer,
                       token_ids=token_ids, **kw)


def load_prompts(config) -> List[str]:
    """Every line of ``validation_prompts_file`` when it exists, else of the
    in-tree prompt list, blank lines included, as the JAX CLI reads it
    (image ``i`` is the prompt of line ``i``)."""
    with open(validation_prompts_file(
            config.get("validation_prompts_file"))) as f:
        return f.read().splitlines()


def main() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")
    config = get_config()
    pipe = build_pipeline(config, device=config.get("device"))
    batch_size = int(config.get("batch_size", 4))
    generator = torch.Generator(device=pipe.device).manual_seed(
        int(config.get("seed", 0)))
    outdir = config.get("output_dir", "outputs_v2")
    os.makedirs(outdir, exist_ok=True)
    prompts = load_prompts(config)
    for step in range(0, len(prompts), batch_size):
        chunk = prompts[step:step + batch_size]
        images = pipe.generate(chunk, generator)
        for i, im in enumerate(to_pil_images(images)):
            im.save(os.path.join(outdir, f"t2i_{step + i:05d}.png"))
        logger.info("generated %d images (step %d)", len(chunk), step)


if __name__ == "__main__":
    main()
