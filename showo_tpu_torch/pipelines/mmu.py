"""Show-o v1 multimodal-understanding pipeline (captioning, VQA).

Counterpart of ``showo_tpu/pipelines/mmu.py``: the discrete path (MAGVIT
codes of the image in the prompt, ``omni_mask_mmu``) and the CLIP-ViT path
(projected CLIP features spliced into the prompt's embeddings,
``omni_mask_mmu_vit``), both decoding over a KV cache
(``showo_mmu_generate``).  ``param_fusion`` re-lays the weights for
inference as the JAX pipeline does; ``quantize_int8`` turns every matmul
of the layout, and ``lm_head``, into the int8 kernel's ``Int8Linear``
(weight-only int8 serving).  Attention stays dense under the additive
mask, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from showo_tpu_torch.models.magvit import MagvitV2
from showo_tpu_torch.models.phi import (fuse_parallel_mlp, fuse_qkv,
                                        quantize_int8)
from showo_tpu_torch.models.showo import Showo, mm_project, showo_mmu_generate
from showo_tpu_torch.ops.masks import omni_mask_mmu, omni_mask_mmu_vit
from showo_tpu_torch.prompting import UniversalPrompting


@dataclasses.dataclass
class MMUPipeline:
    model: Showo
    vq: MagvitV2
    uni_prompting: UniversalPrompting
    max_new_tokens: int = 100
    top_k: Optional[int] = 1
    top_p: Optional[float] = None
    temperature: float = 1.0
    param_fusion: str = "mlp"      # "mlp" | "qkv" | "none"
    quantize_int8: bool = False    # weight-only int8 serving

    def __post_init__(self):
        phi = self.model.showo
        if self.param_fusion == "mlp":
            fuse_parallel_mlp(phi)
        elif self.param_fusion == "qkv":
            fuse_qkv(phi)
        elif self.param_fusion != "none":
            raise ValueError(f"param_fusion {self.param_fusion!r}: mlp, qkv "
                             f"or none")
        if self.quantize_int8:
            quantize_int8(phi)
        self.cfg = self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.showo.model.embed_tokens.weight.device

    def decode(self, toks) -> str:
        """Token ids -> text."""
        try:
            return self.uni_prompting.text_tokenizer.batch_decode(
                [list(toks)], skip_special_tokens=True)[0]
        except AttributeError:
            return str(list(toks))

    def _question_ids(self, text: str) -> np.ndarray:
        ids = self.uni_prompting.text_tokenizer([text])["input_ids"][0]
        return np.asarray(ids, np.int64)

    def _generate(self, generator, injected_gumbel, **kw) -> List[int]:
        eot = self.uni_prompting.sptids["<|eot|>"]
        toks, valid = showo_mmu_generate(
            self.model, generator=generator,
            max_new_tokens=self.max_new_tokens, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p, eot_token=eot,
            injected_gumbel=injected_gumbel, **kw)
        toks, valid = toks[0].cpu().numpy(), valid[0].cpu().numpy()
        return [int(t) for t in toks[valid] if t != eot]

    def prompt(self, image_nhwc: np.ndarray, question: str):
        """The discrete path's prompt ``[mmu][soi] image codes [eoi][sot]
        USER: \\n<question> ASSISTANT:`` ([1, S] ids on the model's device)
        and its mmu mask [1, 1, S, S]."""
        sp = self.uni_prompting.sptids
        pixels = torch.as_tensor(np.asarray(image_nhwc, np.float32),
                                 device=self.device)[None]
        codes = self.vq.get_code(pixels)[0].cpu().numpy()
        codes = codes + self.cfg.codebook_offset
        ids = np.concatenate([
            [sp["<|mmu|>"], sp["<|soi|>"]], codes,
            [sp["<|eoi|>"], sp["<|sot|>"]],
            self._question_ids("USER: \n" + question + " ASSISTANT:")])
        ids = torch.as_tensor(ids, device=self.device)[None]
        return ids, omni_mask_mmu(ids, eoi_id=sp["<|eoi|>"])

    def answer(self, image_nhwc: np.ndarray, question: str,
               generator: Optional[torch.Generator] = None,
               injected_gumbel=None) -> List[int]:
        """Discrete path: the sampled token ids up to the first eot (which
        is dropped)."""
        ids, bias = self.prompt(image_nhwc, question)
        return self._generate(generator, injected_gumbel, prompt_ids=ids,
                              prompt_bias=bias)

    def clip_prompt(self, clip_features, question: str, system_prompt_ids,
                    conversation_prompt: Optional[str] = None):
        """The CLIP-ViT path's prompt embeddings ``[mmu] system [soi]
        projected features [eoi] USER: <question> ASSISTANT:`` [1, S, D]
        and its mask [1, 1, S, S]."""
        sp = self.uni_prompting.sptids
        text = conversation_prompt if conversation_prompt is not None else (
            "USER: " + question + " ASSISTANT:")
        system = np.asarray(system_prompt_ids, np.int64)
        ids = np.concatenate([[sp["<|mmu|>"]], system,
                              [sp["<|soi|>"], sp["<|eoi|>"]],
                              self._question_ids(text)])
        ids = torch.as_tensor(ids, device=self.device)[None]
        embeds = self.model.showo.model.embed_tokens(ids)
        feats = mm_project(self.model, torch.as_tensor(
            clip_features, device=self.device)[None])
        head = 2 + len(system)
        embeds = torch.cat([embeds[:, :head], feats.to(embeds.dtype),
                            embeds[:, head:]], dim=1)
        bias = omni_mask_mmu_vit(1, embeds.shape[1],
                                 system_prompt_len=len(system),
                                 num_patches=feats.shape[1],
                                 device=self.device)
        return embeds, bias

    def answer_with_clip(self, clip_features, question: str,
                         system_prompt_ids,
                         generator: Optional[torch.Generator] = None,
                         conversation_prompt: Optional[str] = None,
                         injected_gumbel=None) -> List[int]:
        """CLIP-ViT path (``w_clip_vit``): features [P, clip_feat_dim]
        (numpy or a tensor) projected by ``mm_projector`` and spliced after
        ``[mmu] system [soi]``; the sampled ids up to the first eot."""
        embeds, bias = self.clip_prompt(clip_features, question,
                                        system_prompt_ids, conversation_prompt)
        return self._generate(generator, injected_gumbel,
                              prompt_embeds=embeds, prompt_bias=bias)
