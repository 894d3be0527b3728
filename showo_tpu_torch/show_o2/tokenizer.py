"""The Show-o2 text tokenizer and its special-token ids
(show-o2/models/misc.py:337-386 ``get_text_tokenizer``).

Counterpart of ``showo_tpu/show_o2/tokenizer.py``: a [PAD] token and
Show-o2's tokens are added, and the ids dict is returned for ``qwen2_5``
(its native vision tokens reused; ``<image>`` and the video markers
added) or ``llama3`` (seven tokens added).  The tokenizer is read from
local files only (``local_files_only=True``): a hub name is never
fetched.
"""

from __future__ import annotations

from typing import Dict

ADDED_TOKENS = {
    "llama3": ("<|img_start|>", "<|img_end|>", "<|image_pad|>",
               "<|video_pad|>", "<|vid_start|>", "<|vid_end|>", "<image>"),
    "qwen2_5": ("<image>", "<|vid_start|>", "<|vid_end|>"),
}

# id name -> the token whose vocabulary id it is (eos_id: the tokenizer's)
TOKEN_NAMES = {
    "llama3": {"bos_id": "<|begin_of_text|>", "boi_id": "<|img_start|>",
               "eoi_id": "<|img_end|>", "bov_id": "<|vid_start|>",
               "eov_id": "<|vid_end|>", "img_pad_id": "<|image_pad|>",
               "vid_pad_id": "<|video_pad|>", "img_id": "<image>"},
    "qwen2_5": {"bos_id": "<|im_start|>", "boi_id": "<|vision_start|>",
                "eoi_id": "<|vision_end|>", "bov_id": "<|vid_start|>",
                "eov_id": "<|vid_end|>", "img_pad_id": "<|image_pad|>",
                "vid_pad_id": "<|video_pad|>", "img_id": "<image>"},
}


def showo_token_ids(tok, llm_name: str = "qwen2_5") -> Dict[str, int]:
    """The special-token ids of a tokenizer that has Show-o2's tokens
    (any ``llm_name`` but ``llama3`` reads Qwen2.5's, as JAX does)."""
    vocab = tok.get_vocab()
    names = TOKEN_NAMES["llama3" if llm_name == "llama3" else "qwen2_5"]
    ids = {"bos_id": vocab[names["bos_id"]], "eos_id": tok.eos_token_id}
    ids.update({k: vocab[v] for k, v in names.items() if k != "bos_id"})
    ids["pad_id"] = tok.pad_token_id
    return ids


def get_text_tokenizer(model_path: str, add_showo_tokens: bool = True,
                       return_showo_token_ids: bool = False,
                       llm_name: str = "qwen2_5"):
    """The tokenizer of the local directory ``model_path`` with [PAD] and
    (``add_showo_tokens``) Show-o2's tokens; with
    ``return_showo_token_ids`` also the ids dict.  Adding the tokens for
    an ``llm_name`` other than ``qwen2_5`` / ``llama3`` raises
    NotImplementedError."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
    tok.add_special_tokens({"pad_token": "[PAD]"})
    if add_showo_tokens:
        if llm_name not in ADDED_TOKENS:
            raise NotImplementedError(llm_name)
        for t in ADDED_TOKENS[llm_name]:
            tok.add_tokens(t)
    if not return_showo_token_ids:
        return tok
    return tok, showo_token_ids(tok, llm_name)
