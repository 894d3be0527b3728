"""Tiny sizes of each configuration for the CPU tests (the published
widths run only on the card)."""

TINY = {
    "showo_1.3b": {
        "model.showo.num_vq_tokens": 64,
        "dataset.params.resolution": 128,
        "dataset.preprocessing.max_seq_length": 16,
        "generation_timesteps": 8,
        "model.showo.phi": {"hidden_size": 64, "intermediate_size": 128,
                            "num_layers": 2, "num_heads": 4},
        "model.vq_model.dims": {"ch": 32, "dec_ch_mult": [1, 1, 2],
                                "dec_num_res_blocks": [1, 1, 1]},
    },
    "showo2_1.5b": {
        "model.showo.hidden_size": 64, "model.showo.llm_vocab_size": 1100,
        "model.showo.llm_intermediate_size": 128,
        "model.showo.llm_num_layers": 2, "model.showo.llm_num_heads": 4,
        "model.showo.llm_num_kv_heads": 2, "model.showo.llm_head_dim": 16,
        "model.showo.clip_latent_dim": 48,
        "model.showo.siglip": {"hidden_size": 48, "intermediate_size": 96,
                               "num_heads": 4, "num_layers": 2,
                               "num_positions": 16},
        "model.showo.dit": {"hidden_size": 96, "intermediate_size": 192,
                            "num_heads": 4, "num_kv_heads": 2,
                            "head_dim": 24},
        "model.showo.num_diffusion_layers": 2,
        "model.showo.image_latent_height": 8,
        "model.showo.image_latent_width": 8,
        "model.vae_model.dims": {"dim": 16, "dim_mult": [1, 2],
                                 "num_res_blocks": 1,
                                 "temperal_downsample": [True]},
        "transport.num_inference_steps": 5,
        "dataset.preprocessing.max_text_len": 12,
    },
}


# training a little wider: at hidden 64 the control's fp8 rounding reads
# under the limits set at the published widths
TRAIN = dict(TINY["showo2_1.5b"], **{
    "model.showo.hidden_size": 256, "model.showo.llm_intermediate_size": 512,
    "model.showo.llm_head_dim": 64, "model.showo.llm_num_heads": 4,
    "dataset.preprocessing.resolution": 16,
    "dataset.preprocessing.max_seq_length": 48,
    "dataset.preprocessing.num_t2i_image_tokens": 16,
    "dataset.preprocessing.max_text_len": 12,
    "training.batch_size_t2i": 2, "training.batch_size_mmu": 2,
    "training.warmup_steps": 0})


def tiny(cell_name: str) -> dict:
    from benchmark import harness

    wl = harness.cell(cell_name)
    if wl["entry"] == "train_v2":
        return TRAIN
    if wl["program"] == "t2i_512":
        # a latent grid off the position table's 4 x 4: the table resized
        return dict(TINY[wl["config"]], **{
            "model.showo.image_latent_height": 12,
            "model.showo.image_latent_width": 12})
    return TINY[wl["config"]]
