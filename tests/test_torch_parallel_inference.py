"""Generation and serving on sharded v1 models over 8 gloo ranks.

JAX twins: ``tests/test_parallel_inference.py`` (the cached MaskGIT
sampler at dp=4, fsdp=2 and the AR understanding decoder at dp=8, each
rank its own rows; here the tokens are held to the unsharded port's
under the same injected noise) and ``tests/test_serving.py::
test_serving_engine_on_mesh`` (the slot engine on a (2, 2, 2) mesh,
token-exact against the per-request decode on the same sharded model:
tp's reduction order may flip a greedy near-tie against the unsharded
model, so sharded is held to sharded; both the plain layout and
``fuse_parallel_mlp``'s, whose fused projections run tensor-parallel).
The ranks run every case in one group (``tests/_gloo_group.py``, 180 s
wall-time limit) while this process runs the unsharded references.
"""

import os

import numpy as np
import pytest
import torch

from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.models import showo as tshowo
from showo_tpu_torch.ops.masks import omni_mask_mmu, omni_mask_predict_next
from showo_tpu_torch.parallel import mesh as tmesh
from _gloo_group import start_group

WORLD = 8
B = 8
PAD, SOI, EOI, MMU = 102, 103, 104, 105
CFG = tshowo.ShowoConfig(
    vocab_size=130, llm_vocab_size=100, num_new_special_tokens=6,
    codebook_size=16, num_vq_tokens=9,
    llm=tphi.PhiConfig(vocab_size=130, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, max_position_embeddings=128))
P_LEN, STEPS, NEW = 6, 3, 5
SERVE_CFG = tshowo.ShowoConfig(
    vocab_size=120, llm_vocab_size=100, num_new_special_tokens=3,
    codebook_size=16, num_vq_tokens=9,
    llm=tphi.PhiConfig(vocab_size=120, hidden_size=64, intermediate_size=128,
                       num_layers=2, num_heads=4, max_position_embeddings=128))
S_SOI, S_EOI, S_MMU = 101, 102, 105      # the serving model's specials
SERVE_REQS = [(3, 5), (7, 8), (2, 4)]
SERVE_KW = dict(slots=2, cap=48, chunk=3, buckets=(16, 24), temperature=1.0,
                top_k=1)


def _model(cfg, seed):
    return tshowo.init_showo(cfg, torch.Generator().manual_seed(seed))


def _t2i_inputs():
    rng = np.random.default_rng(0)
    text = rng.integers(2, 90, size=(B, P_LEN - 1))
    ids = np.concatenate([text, np.full((B, 1), SOI),
                          np.full((B, CFG.num_vq_tokens), CFG.mask_token_id),
                          np.full((B, 1), EOI)], axis=1)
    uncond = ids.copy()
    uncond[:, :P_LEN - 1] = PAD
    ids, uncond = torch.as_tensor(ids), torch.as_tensor(uncond)
    bias = omni_mask_predict_next(torch.cat([ids, uncond]), PAD, SOI, EOI,
                                  rm_pad_in_image=True)
    N, C = CFG.num_vq_tokens, CFG.codebook_size
    noise = (torch.as_tensor(rng.gumbel(size=(STEPS, B, N, C)),
                             dtype=torch.float32),
             torch.as_tensor(rng.gumbel(size=(STEPS, B, N)),
                             dtype=torch.float32))
    return ids, uncond, bias, noise


def _t2i(model, rows=slice(None)):
    ids, uncond, bias, noise = _t2i_inputs()
    n = ids.shape[0]
    bias = torch.cat([bias[:n][rows], bias[n:][rows]])
    with torch.no_grad():
        return tshowo.showo_t2i_generate_cached(
            model, ids[rows], uncond_input_ids=uncond[rows],
            attention_bias=bias, guidance_scale=1.5, timesteps=STEPS,
            max_seq_length=P_LEN - 1, pad_id=PAD, soi_id=SOI, eoi_id=EOI,
            injected_noise=tuple(g[:, rows] for g in noise))


def _mmu(model, rows=slice(None)):
    rng = np.random.default_rng(1)
    img = rng.integers(CFG.codebook_offset,
                       CFG.codebook_offset + CFG.codebook_size,
                       size=(B, CFG.num_vq_tokens))
    q = rng.integers(2, 90, size=(B, 4))
    prompt = torch.as_tensor(np.concatenate([
        np.full((B, 1), MMU), np.full((B, 1), SOI), img,
        np.full((B, 1), EOI), q], axis=1))[rows]
    with torch.no_grad():
        toks, _ = tshowo.showo_mmu_generate(
            model, prompt, prompt_bias=omni_mask_mmu(prompt, eoi_id=EOI),
            max_new_tokens=NEW, top_k=1)
    return toks


def _serve_reqs():
    rng = np.random.default_rng(21)
    out = []
    for q, budget in SERVE_REQS:
        img = rng.integers(106, 120, size=9)
        qs = rng.integers(2, 99, size=q)
        out.append((np.concatenate([[S_MMU, S_SOI], img, [S_EOI],
                                    qs]).astype(np.int32), budget))
    return out


def _serve(model):
    """(engine streams, per-request greedy decode) on ``model``."""
    from showo_tpu_torch.serving import ShowoMMUServer

    reqs = _serve_reqs()
    with torch.no_grad():
        server = ShowoMMUServer(model, **SERVE_KW)
        handles = [server.submit(p, b) for p, b in reqs]
        server.run(torch.Generator().manual_seed(3))
        ref = []
        for p, b in reqs:
            ids = torch.as_tensor(p, dtype=torch.long)[None]
            toks, _ = tshowo.showo_mmu_generate(
                model, ids, prompt_bias=omni_mask_mmu(ids, eoi_id=S_EOI),
                max_new_tokens=b, top_k=1)
            ref.append(toks[0].tolist())
    return [h.tokens for h in handles], ref


def infer_worker(rank, world, workdir):
    out = {}
    model = tmesh.shard_params(_model(CFG, 0), tmesh.make_mesh(4, 2, 1))
    info = tmesh.mesh_of(model)
    n = B // info.data_world
    rows = slice(info.data_rank * n, (info.data_rank + 1) * n)
    out["t2i"] = _t2i(model, rows)
    model = tmesh.shard_params(_model(CFG, 0), tmesh.make_mesh(8, 1, 1))
    out["mmu"] = _mmu(model, slice(rank, rank + 1))
    mesh = tmesh.make_mesh(2, 2, 2)
    for layout in ("plain", "fused"):
        model = _model(SERVE_CFG, 4)
        if layout == "fused":
            tphi.fuse_parallel_mlp(model.showo)
        tmesh.shard_params(model, mesh)
        out[("serve", layout)] = _serve(model)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("infer"))
    group = start_group("test_torch_parallel_inference:infer_worker", WORLD,
                        workdir)
    try:
        model = _model(CFG, 0)
        want = {"t2i": _t2i(model), "mmu": _mmu(model)}
    except BaseException:
        group.kill()
        raise
    group.wait(timeout=180)
    return [torch.load(os.path.join(workdir, f"out{r}.pt"))
            for r in range(WORLD)], want


def test_t2i_cached_generate_on_mesh(run):
    """(4, 2, 1): each (dp, fsdp) rank generates its rows; the tp-less
    ranks' tokens, in rank order, are the unsharded port's."""
    outs, want = run
    got = torch.cat([outs[r]["t2i"] for r in range(WORLD)])
    assert got.shape == (B, CFG.num_vq_tokens)
    assert torch.equal(got, want["t2i"])
    assert ((got >= 0) & (got < CFG.codebook_size)).all()


def test_mmu_generate_on_mesh(run):
    """(8, 1, 1): one row a rank, greedy, the unsharded port's tokens."""
    outs, want = run
    got = torch.cat([outs[r]["mmu"] for r in range(WORLD)])
    assert got.shape == (B, NEW)
    assert torch.equal(got, want["mmu"])


@pytest.mark.parametrize("layout", ["plain", "fused"])
def test_serving_engine_on_mesh(run, layout):
    outs, _ = run
    streams, ref = outs[0][("serve", layout)]
    assert [len(t) for t in streams] == [b for _, b in SERVE_REQS]
    assert streams == ref
    for r in range(1, WORLD):
        assert outs[r][("serve", layout)] == (streams, ref), r
