"""The port's sharding rules against the JAX package's (in process).

JAX twins: ``tests/test_parallel_inference.py::test_fused_params_shard_rules``,
``tests/test_parallel_train.py::test_fsdp_actually_shards``,
``tests/test_parallel_train_v2.py::test_v2_params_actually_shard`` and
``tests/test_7b_sharded_compile.py::test_7b_params_fully_sharded`` (and
its ``test_7b_train_step_compiles_sharded``'s state, reckoned on the meta
device by ``tests/_reckon_state.py``): for
every parameter of the tiny v1 model (plain and ``fuse_parallel_mlp``),
the tiny Show-o2 model and the Show-o2 7B config's shapes (on the meta
device), the spec of ``showo_tpu_torch.parallel.mesh.param_sharding_rules``
is JAX's ``param_sharding_rules`` of the counterpart leaf on the
8-virtual-device mesh, carried to the port tensor's dims through
``training/optim.py::_perm``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from showo_tpu.parallel.mesh import make_mesh as jmake_mesh
from showo_tpu.parallel.mesh import param_sharding_rules as jrules
from showo_tpu_torch.parallel import mesh as tmesh
from showo_tpu_torch.training.optim import _perm

MESHES = [(2, 2, 2), (1, 8, 1), (2, 1, 4), (1, 2, 4)]


def _v1_cfgs(w_clip_vit=False):
    from showo_tpu.models.phi import PhiConfig as JPhi
    from showo_tpu.models.showo import ShowoConfig as JShowo
    from showo_tpu_torch.models.phi import PhiConfig as TPhi
    from showo_tpu_torch.models.showo import ShowoConfig as TShowo

    llm = dict(vocab_size=130, hidden_size=64, intermediate_size=128,
               num_layers=2, num_heads=4)
    rest = dict(vocab_size=130, llm_vocab_size=100, num_new_special_tokens=6,
                codebook_size=16, num_vq_tokens=9, w_clip_vit=w_clip_vit,
                clip_feat_dim=48)
    return JShowo(llm=JPhi(**llm), **rest), TShowo(llm=TPhi(**llm), **rest)


def _jax_leaves(params, shape):
    """{JAX leaf path: (shape, spec padded to the leaf's rank)}."""
    mesh = jmake_mesh(*shape)
    shardings = jrules(params, mesh)
    out = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree.leaves(shardings)):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        out[key] = (tuple(leaf.shape), spec)
    return out


def _owner(model, name):
    mname, _, pname = name.rpartition(".")
    return model.get_submodule(mname), pname


def _check(model, jparams, shape):
    """Every port parameter's spec is its JAX leaf's, carried through
    ``_perm``; the port's tensors cover every JAX leaf."""
    leaves = _jax_leaves(jparams, shape)
    sizes = dict(zip(("dp", "fsdp", "tp"), shape))
    specs = tmesh.param_sharding_rules(model, sizes)
    seen = set()
    for name, p in model.named_parameters():
        spec = specs[name]
        assert spec.path in leaves, (name, spec.path)
        jshape, jspec = leaves[spec.path]
        seen.add(spec.path)
        assert spec.jax == jspec, (name, spec.jax, jspec)
        mod, pname = _owner(model, name)
        perm = _perm(mod, pname, p)
        piece = jspec[1:] if len(jshape) == p.dim() + 1 else jspec
        assert tuple(p.shape[i] for i in perm) == jshape[-p.dim():], name
        want = [None] * p.dim()
        for j, entry in enumerate(piece):
            want[perm[j]] = entry
        assert spec.dims == tuple(want), (name, spec.dims, want)
    assert seen == set(leaves), sorted(set(leaves) - seen)[:5]
    return specs


@functools.lru_cache(maxsize=None)
def _jax_params(init, cfg):
    """The JAX tree's shapes (``init(cfg, key)`` traced, not run)."""
    return jax.eval_shape(lambda k: init(cfg, k), jax.random.PRNGKey(0))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("layout", ["plain", "fused", "clip"])
def test_v1_specs_equal_jax(shape, layout):
    from showo_tpu.models.phi import fuse_parallel_mlp as jfuse
    from showo_tpu.models.showo import init_showo_params
    from showo_tpu_torch.models.phi import fuse_parallel_mlp
    from showo_tpu_torch.models.showo import Showo

    jcfg, tcfg = _v1_cfgs(w_clip_vit=layout == "clip")
    params = _jax_params(init_showo_params, jcfg)
    model = Showo(tcfg, device="meta")
    if layout == "fused":
        params = dict(params, showo=jax.eval_shape(jfuse, params["showo"]))
        fuse_parallel_mlp(model.showo)
    specs = _check(model, params, shape)
    if layout == "fused" and shape == (2, 2, 2):
        win = specs["showo.model.layers.0.win.weight"]
        wout = specs["showo.model.layers.0.wout.weight"]
        assert win.dims == (("fsdp", "tp"), None)     # torch [out, in]
        assert wout.dims == (None, ("fsdp", "tp"))


@pytest.mark.parametrize("shape", MESHES)
def test_show_o2_specs_equal_jax(shape):
    from showo_tpu.show_o2.showo2 import init_showo2_params
    from test_torch_show_o2_train import tiny_cfgs
    from showo_tpu_torch.show_o2.showo2 import Showo2

    jcfg, tcfg = tiny_cfgs()
    params = _jax_params(init_showo2_params, jcfg)
    _check(Showo2(tcfg, device="meta"), params, shape)


def _7b():
    from showo_tpu.config import load_config as jload
    from showo_tpu.inference_t2i_v2 import build_showo2_config as jbuild
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.inference_t2i_v2 import build_showo2_config

    path = "configs/showo2_7b_stage_1_b.yaml"
    return jbuild(jload(path)), build_showo2_config(load_config(path))


@pytest.mark.parametrize("shape", [(1, 8, 1), (1, 2, 4)])
def test_7b_specs_equal_jax_and_fully_sharded(shape):
    """The 7B config's shapes: every spec JAX's, and (fsdp=8) every tensor
    of 8 MB or more split 8 ways, Qwen's embedding (vocab 151940, not a
    multiple of 8) on its hidden axis."""
    import jax.numpy as jnp
    from showo_tpu.show_o2.showo2 import init_showo2_params
    from showo_tpu_torch.show_o2.showo2 import Showo2

    jcfg, tcfg = _7b()
    params = _jax_params(functools.partial(init_showo2_params,
                                           dtype=jnp.bfloat16), jcfg)
    model = Showo2(tcfg, device="meta", dtype=torch.bfloat16)
    specs = _check(model, params, shape)
    if shape != (1, 8, 1):
        return
    embed = specs["showo.model.embed_tokens.weight"]
    assert embed.dims == (None, "fsdp")
    per_rank = 0
    for name, p in model.named_parameters():
        factor = int(np.prod([shape[("dp", "fsdp", "tp").index(a)]
                              for e in specs[name].dims
                              for a in tmesh._axes(e)] or [1]))
        nbytes = p.numel() * p.element_size()
        if nbytes >= 8 * 2 ** 20:
            assert factor >= 8, (name, tuple(p.shape))
        per_rank += nbytes // factor
    assert per_rank < 3e9, per_rank


@pytest.fixture(scope="module")
def reckoned_7b_stage1():
    """tests/_reckon_state.py over the 7B stage-1b config at fsdp 8 and 4,
    in a process of its own (its fake process group of 8 or 4 ranks)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    done = subprocess.run(
        [sys.executable, os.path.join(here, "_reckon_state.py"),
         "configs/showo2_7b_stage_1_b.yaml", "8", "4"],
        cwd=os.path.dirname(here), capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fsdp", [8, 4])
@pytest.mark.parametrize("name", ["adamw", "adamw_bf16", "adafactor"])
def test_7b_stage1_state_sharded_like_its_parameters(reckoned_7b_stage1,
                                                     fsdp, name):
    """JAX's ``test_7b_train_step_compiles_sharded``: the 7B stage-1b
    state (8.54 B trained, ``frozen_params`` frozen) on the meta device
    over fsdp 8 and 4, each optimizer's own state (AdamW's moments after
    one step).  Every state tensor that keeps an axis the mesh splits is
    split over as many ranks as its parameter, and so is every one of 8
    MiB or more (adamw's and adamw_bf16's moments; a rank holds 1 / fsdp
    of them, bar the replicated norms and biases, 1%).  Adafactor's
    factored statistics are all smaller, 17.4 MB whole: the 27 that keep
    a split axis are split, and a row or column mean over the split axis
    stays whole on each rank."""
    r = reckoned_7b_stage1[str(fsdp)][name]
    assert r["trained"] > 8e9
    assert r["kept_split"] > 0
    assert r["kept_split"] == r["kept_split_like_param"]
    assert r["big"] == r["big_kept_split"] == r["big_split_like_param"]
    assert r["param_bytes"] * fsdp <= 1.01 * 4 * 8.9e9
    if name == "adafactor":
        assert r["big"] == 0 and r["state_bytes_whole"] < 2e7
        return
    assert r["big"] > 400
    assert r["state_bytes"] * fsdp <= 1.01 * r["state_bytes_whole"]


def test_mesh_shape_fills_dp_and_raises():
    """JAX ``make_mesh``: dp=None fills the world; a product other than
    the world raises."""
    assert tmesh.mesh_shape(8, None, 2, 2) == {"dp": 2, "fsdp": 2, "tp": 2}
    assert tmesh.mesh_shape(8, None, 8) == {"dp": 1, "fsdp": 8, "tp": 1}
    assert tmesh.mesh_shape(1) == {"dp": 1, "fsdp": 1, "tp": 1}
    for bad in ((8, 3, 2, 1), (6, None, 4, 1), (8, 2, 2, 1)):
        with pytest.raises(ValueError, match="ranks"):
            tmesh.mesh_shape(*bad)


def test_world_of_one_shards_and_matches_unsharded():
    """A world of one meets without torchrun's environment (the card's
    smoke): the (1, 1, 1) mesh, every parameter a DTensor behind its
    gather, a step's loss, gradients and update equal to the unsharded
    model's, and the whole state dict back under the unsharded names; a
    DTensor handed to a kernel's wrapper raises rather than running the
    plain version."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from showo_tpu_torch.models.phi import Phi, PhiConfig
    from showo_tpu_torch.models.showo import cross_entropy_ignore

    assert not dist.is_initialized()
    cfg = PhiConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                    num_layers=2, num_heads=4)
    g = torch.Generator().manual_seed(0)
    ref = Phi(cfg).init_random(g)
    ids = torch.randint(0, 64, (3, 7), generator=g)
    try:
        dev = tmesh.init_distributed("cpu")
        assert dev == torch.device("cpu")
        mesh = tmesh.make_mesh()
        assert tuple(mesh.mesh.shape) == (1, 1, 1)
        model = Phi(cfg)
        model.load_state_dict(ref.state_dict())
        tmesh.shard_params(model, mesh)
        assert all(isinstance(p, DTensor) for p in model.parameters())
        for m, sharded in ((ref, False), (model, True)):
            with tmesh.use_mesh(tmesh.mesh_of(m)):
                logits, _ = m(input_ids=ids, remat="full")
                loss = cross_entropy_ignore(logits[:, :-1], ids[:, 1:])
            grads = torch.autograd.grad(loss, list(m.parameters()))
            if sharded:
                got = (loss, [tmesh.full_tensor(x) for x in grads])
            else:
                want = (loss, list(grads))
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        sd = tmesh.full_state_dict(model)
        assert sd.keys() == ref.state_dict().keys()
        for k, v in ref.state_dict().items():
            assert torch.equal(sd[k], v)
        from showo_tpu_torch.ops.flash_attention import omni_attention

        q = DTensor.from_local(torch.zeros(1, 2, 4, 8), mesh,
                               tmesh.replicated(mesh))
        with pytest.raises(TypeError, match="DTensor"):
            omni_attention(q, q, q, torch.zeros((1, 4), dtype=torch.int32))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_v1_cli_reads_the_parallel_block(tmp_path):
    """JAX ``train_showo.main``'s ``parallel:`` block: inside a process
    group (a world of one on the CPU: gloo) the CLI makes the (1, 1, 1)
    mesh of the block and trains the sharded model; two steps with a
    checkpoint give the weights of the same run in one process, which
    makes no group and no mesh, and the checkpoint holds the unsharded
    names.  Outside a group a block that asks for more ranks raises."""
    import torch.distributed as dist
    from test_torch_train_showo_fit import _cli_args
    from showo_tpu_torch.training import train_showo as ttrain

    args = _cli_args(tmp_path, tmp_path / "plain") + [
        "training.max_train_steps=2"]
    plain = ttrain.main(args)
    assert not dist.is_initialized() and tmesh.mesh_of(plain.model) is None
    with pytest.raises(ValueError, match="torchrun"):
        ttrain.main(args + ["parallel.fsdp=2"])
    out = tmp_path / "mesh"
    try:
        tmesh.init_distributed("cpu")
        sharded = ttrain.main(_cli_args(tmp_path, out) + [
            "training.max_train_steps=2", "experiment.save_every=2",
            "parallel={dp: null, fsdp: 1, tp: 1}"])
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        info = tmesh.mesh_of(sharded.model)
        assert info.size == {"dp": 1, "fsdp": 1, "tp": 1}
        got = tmesh.full_state_dict(sharded.model)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    want = plain.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6, msg=k)
    saved = torch.load(out / "checkpoint-2" / "state.pt", weights_only=False)
    assert saved["model"].keys() == want.keys()


def _process_dataset(kind, root):
    """(make(process) -> a dataset of ``kind`` over 10 records in
    ``root``, the row a yielded sample stands for) with ``__getitem__``
    returning the record's index; records are sharded at construction
    (jsonl) or at iteration (the rest)."""
    import json
    import os

    from showo_tpu_torch.data import image_text, imagenet, llava
    from showo_tpu_torch.data import mmu_dataset, vist_dataset
    from showo_tpu_torch.inference_t2i_v2 import (FAKE_TOKEN_IDS,
                                                  FakeQwenTokenizer)

    n, tok = 10, FakeQwenTokenizer()
    path = os.path.join(root, "records.json")
    if kind == "imagenet":
        for i in range(n):
            d = os.path.join(root, f"n{i % 2}")
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, f"{i}.jpg"), "w").close()
        return imagenet.ImageNetDataset, lambda p: imagenet.ImageNetDataset(
            root, 8, process=p)
    if kind == "image_text":
        with open(path, "w") as f:
            f.writelines(json.dumps({"path": f"{i}.png", "prompt": "x"})
                         + "\n" for i in range(n))
        return image_text.ImageTextDataset, lambda p: \
            image_text.ImageTextDataset(path, tok, FAKE_TOKEN_IDS, process=p)
    recs = [{"image": f"{i}.png", "conversations": [], "sentences": [],
             "images": []} for i in range(n)]
    with open(path, "w") as f:
        json.dump(recs, f)
    return {"llava": (llava.LLaVADataset,
                      lambda p: llava.LLaVADataset(path, root, tok,
                                                   process=p)),
            "mmu": (mmu_dataset.MMUDataset,
                    lambda p: mmu_dataset.MMUDataset(path, root, tok,
                                                     FAKE_TOKEN_IDS,
                                                     process=p)),
            "vist": (vist_dataset.VISTDataset,
                     lambda p: vist_dataset.VISTDataset(path, root, tok,
                                                        FAKE_TOKEN_IDS,
                                                        process=p))}[kind]


@pytest.mark.parametrize("kind", ["imagenet", "image_text", "llava", "mmu",
                                  "vist"])
def test_datasets_read_their_process_rows(tmp_path, kind, monkeypatch):
    """Each dataset a trainer builds on a mesh takes ``process=(rank,
    world)`` (the model's ``data/loader.py::data_shard``): the 4 shards of
    one pass are disjoint and hold every record once; without it a
    process outside a group reads them all."""
    cls, make = _process_dataset(kind, str(tmp_path))
    if kind == "imagenet":
        monkeypatch.setattr(cls, "__getitem__",
                            lambda self, i: self.samples[i][0])
    else:
        monkeypatch.setattr(cls, "__getitem__",
                            lambda self, i: self.records[i]["path" if kind
                                                            == "image_text"
                                                            else "image"])
    whole = sorted(make(None))
    assert len(whole) == 10 and len(set(whole)) == 10
    shards = [list(make((r, 4))) for r in range(4)]
    assert [len(s) for s in shards] == [3, 3, 2, 2]
    assert sorted(x for s in shards for x in s) == whole
