"""The ("dp", "fsdp", "tp") device mesh and its sharding rules.

Counterpart of ``showo_tpu/parallel/mesh.py``.  One process a card (or,
on the CPU, a gloo rank); :func:`init_distributed` joins the process
group, :func:`make_mesh` lays the ranks out as a ("dp", "fsdp", "tp")
``DeviceMesh`` and :func:`shard_params` shards a model over it by the
JAX package's rule table (a copy of ``_DEFAULT_RULES`` and ``_fit_spec``,
matched against the JAX path of each of the port's parameters):

* data parallelism: each (dp, fsdp) coordinate takes its own batch rows
  (:func:`shard_batch`, the ``data/loader.py`` process shard); the "tp"
  ranks of one coordinate take the same rows;
* "fsdp": a parameter's storage is split over the fsdp ranks on the dim
  the rule names (ZeRO-3; replicated over dp: HSDP).  Each access of the
  parameter in a forward gathers it (``torch.nn.utils.parametrize``),
  and the gather's backward reduce-scatters the gradient over fsdp and
  sums it over dp.  In a step (:func:`use_mesh`) a gathered weight that
  autograd saves is kept as its shard and gathered again in the
  backward, so the whole weights are not all held at once;
* "tp": the storage is split further over tp (fsdp major, as JAX's
  ``("fsdp", "tp")`` tuple), and an ``nn.Linear`` split so runs
  tensor-parallel: a rank gathers its tp block over fsdp only and
  computes its share of the output columns (a split output axis) or of
  the contraction (a split input axis, the partial products summed over
  tp); the output is gathered back whole, so every layer, norm and hand
  kernel after it sees plain tensors of the whole width, its heads
  intact.  Attention itself runs whole on each tp rank.

Every parameter is a ``DTensor`` on the mesh with the rule's placements
(``Replicate`` over dp, ``Shard(dim)`` over fsdp / tp), so an optimizer,
the EMA and a checkpoint see its global shape; the gradients are
DTensors of the same placements, summed over the data ranks.  A loss
that is a mean over the rows of the global batch divides by the count of
the whole batch (:func:`global_mean`), so the sharded step takes the
gradient of the unsharded one.

The cards meet over NCCL; on the CPU, gloo.  No rendezvous beyond
torchrun's environment (or the caller's store) is read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import types
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

AXES = ("dp", "fsdp", "tp")
DATA_AXES = ("dp", "fsdp")
FT = ("fsdp", "tp")


def init_distributed(device=None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     store=None) -> torch.device:
    """Join the process group; returns this rank's device.

    rank / world_size / local_rank default to torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` (0 / 1 / rank without them).  The
    backend is NCCL on ``cuda:<local_rank>`` (``device`` None or CUDA;
    raises without a card) and gloo when the caller asks for the CPU;
    there is no fallback from one to the other.  The rendezvous is
    ``store`` when given, else torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT``; a world of 1 without either meets in a ``HashStore``.
    A group already up is kept when its backend and world size match."""
    from showo_tpu_torch.utils.device import entry_device

    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world = (int(env.get("WORLD_SIZE", 1)) if world_size is None
             else int(world_size))
    local = (int(env.get("LOCAL_RANK", rank)) if local_rank is None
             else int(local_rank))
    dev = entry_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks is up; asked for {backend} over {world}")
        return dev
    kw = dict(backend=backend, rank=rank, world_size=world)
    if store is None and "MASTER_ADDR" not in env:
        if world != 1:
            raise ValueError(f"a world of {world} ranks needs a store or "
                             f"torchrun's MASTER_ADDR / MASTER_PORT")
        store = dist.HashStore()
    if store is not None:
        kw["store"] = store
    dist.init_process_group(**kw)
    return dev


def mesh_shape(world: int, dp: Optional[int] = None, fsdp: int = 1,
               tp: int = 1) -> Dict[str, int]:
    """{"dp", "fsdp", "tp"} sizes over ``world`` ranks; ``dp=None`` fills
    the world.  Sizes whose product is not the world raise ValueError."""
    fsdp, tp = int(fsdp or 1), int(tp or 1)
    if dp is None:
        dp = world // (fsdp * tp)
    dp = int(dp)
    if dp < 1 or dp * fsdp * tp != world:
        raise ValueError(f"{dp}*{fsdp}*{tp} != {world} ranks")
    return {"dp": dp, "fsdp": fsdp, "tp": tp}


def make_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1):
    """A ("dp", "fsdp", "tp") ``DeviceMesh`` over the process group's
    ranks ("cuda" under NCCL, "cpu" under gloo), rank r at (r // (fsdp*tp),
    r // tp % fsdp, r % tp); ``dp=None`` fills the world."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    s = mesh_shape(world, dp, fsdp, tp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world).reshape(s["dp"], s["fsdp"], s["tp"])
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def _sizes(mesh) -> Dict[str, int]:
    """The axis sizes of a DeviceMesh, or of a {axis: size} mapping."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return {a: mesh.size(mesh.mesh_dim_names.index(a)) for a in AXES}


# ---------------------------------------------------------------------------
# the rule table (a copy of the JAX package's), over JAX paths

# Sharding rules for the JAX package's parameter paths.  Matched by path
# suffix; first match wins.  Kernels shard the largest contraction-free
# axis over fsdp, attention/MLP output axes over tp.  A spec is a tuple of
# entries, one a JAX axis: None, a mesh axis, or a tuple of mesh axes.
_DEFAULT_RULES: Sequence[tuple] = (
    # stacked transformer layers (phi/qwen2/dit/siglip): [L, in, out];
    # win/wout are the fuse_parallel_mlp fused kernels
    (r"layers/(q|k|v|qkv|fc1|gate|up|gu|win)/kernel$", (None, None, FT)),
    (r"layers/(dense|o|out|fc2|down|wout)/kernel$", (None, FT, None)),
    (r"layers/adaln/kernel$", (None, None, FT)),
    (r"layers/.*/bias$", ()),
    (r"layers/.*/scale$", ()),
    (r"embed$", ("fsdp", None)),
    (r"lm_head/kernel$", (None, FT)),
    (r"lm_head/bias$", ()),
    # unstacked 2D projections (fusion_proj, diff_proj, time_embed,
    # final-layer adaln, ...)
    (r"(fc1|fc2|linear|adaln|proj|kernel)/kernel$", (None, FT)),
    # conv codecs: [kh, kw, I, O] or [kT, kH, kW, I, O]
    (r"kernel$", (None, None, None, "fsdp")),
    (r".*", ()),
)


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry if isinstance(entry, tuple)
                                     else (entry,))


def _fit_spec(spec: tuple, shape: Sequence[int], sizes: Mapping[str, int],
              exclude_dims=()) -> tuple:
    """JAX ``_fit_spec``: drop a spec entry whose axes do not divide its
    dim, and move it to the largest still-unsharded dim they divide (not
    one of ``exclude_dims``), or replicate it when there is none (Qwen's
    vocab 151940 over 8 moves to the hidden axis)."""
    if len(spec) > len(shape):
        return ()
    out, dropped = [], []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if axes is None:
            out.append(None)
            continue
        size = int(np.prod([sizes[a] for a in _axes(axes)]))
        if dim % size == 0:
            out.append(axes)
        else:
            out.append(None)
            dropped.append(axes)
    for axes in dropped:
        size = int(np.prod([sizes[a] for a in _axes(axes)]))
        cands = [i for i, (dim, cur) in enumerate(zip(shape, out))
                 if cur is None and dim % size == 0 and dim >= size
                 and i not in exclude_dims]
        if cands:
            out[max(cands, key=lambda i: shape[i])] = axes
    return tuple(out)


def jax_spec(path: str, shape: Sequence[int], mesh) -> tuple:
    """The JAX package's spec of the leaf at ``path`` of ``shape`` on
    ``mesh`` (a DeviceMesh or {axis: size})."""
    excl = (0,) if "layers/" in path else ()
    for pat, spec in _DEFAULT_RULES:
        if re.search(pat, path):
            return _fit_spec(spec, shape, _sizes(mesh), exclude_dims=excl)
    return ()


# ---------------------------------------------------------------------------
# the JAX path of each of the port's parameters

# layer stacks: the port's ModuleList -> the JAX package's stacked subtree
_STACKS = ((r"showo\.model\.layers", "showo/layers"),
           (r"und_trans\.layers", "und_trans/layers"),
           (r"diffusion_head_a", "diffusion_head_a/layers"))

# the modules of one layer, port name -> JAX name
_LAYER = {"self_attn.q_proj": "q", "self_attn.k_proj": "k",
          "self_attn.v_proj": "v", "self_attn.qkv": "qkv",
          "self_attn.dense": "dense", "self_attn.o_proj": "o",
          "self_attn.out_proj": "out", "mlp.fc1": "fc1", "mlp.fc2": "fc2",
          "mlp.gate_proj": "gate", "mlp.up_proj": "up",
          "mlp.down_proj": "down", "mlp.gu": "gu", "win": "win",
          "wout": "wout", "adaLN_modulation.1": "adaln",
          "post_attention_layernorm": "post_ln",
          "self_attn.q_layernorm": "q_ln", "self_attn.k_layernorm": "k_ln",
          "self_attn.q_norm": "q_norm", "self_attn.k_norm": "k_norm",
          "layer_norm1": "ln1", "layer_norm2": "ln2"}

# modules outside the stacks, port name -> JAX path
_TOP = {"showo.model.embed_tokens": "showo/embed",
        "showo.model.final_layernorm": "showo/final_ln",
        "showo.model.norm": "showo/final_ln",
        "showo.lm_head": "showo/lm_head",
        "mm_projector.0": "mm_projector/fc1",
        "mm_projector.2": "mm_projector/fc2",
        "image_embedder_und.proj": "image_embedder_und",
        "image_embedder_gen.proj": "image_embedder_gen",
        "position_embedding": "und_trans/pos_embed",
        "fusion_proj.0": "fusion_proj/norm",
        "fusion_proj.1": "fusion_proj/fc1",
        "fusion_proj.3": "fusion_proj/fc2",
        "time_embed.mlp.0": "time_embed/fc1",
        "time_embed.mlp.2": "time_embed/fc2",
        "diffusion_head_b.norm_final": "diffusion_head_b/norm",
        "diffusion_head_b.adaLN_modulation.1": "diffusion_head_b/adaln",
        "diff_proj.0": "diff_proj/fc1", "diff_proj.2": "diff_proj/fc2"}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter's sharding: its JAX leaf ``path`` and that leaf's
    ``jax`` spec (over JAX's axes: the layer axis first for a stack,
    Linear kernels [in, out], convolutions HWIO), and ``dims``, the same
    entries carried to the port tensor's own dims through ``perm`` (the
    JAX axis order of the tensor)."""

    path: str
    jax: tuple
    perm: Tuple[int, ...]
    dims: tuple

    def dim(self, axis: str) -> Optional[int]:
        """The port dim split over mesh ``axis``, or None."""
        for d, entry in enumerate(self.dims):
            if axis in _axes(entry):
                return d
        return None


def clean_name(name: str) -> str:
    """A parameter's name without the ``parametrizations.<x>.original``
    hop that :func:`shard_params` adds."""
    return re.sub(r"parametrizations\.(\w+)\.original$", r"\1", name)


def named_parameters(model: nn.Module) -> Iterator[Tuple[str, nn.Parameter]]:
    """``model.named_parameters()`` under the names of the unsharded
    model."""
    for n, p in model.named_parameters():
        yield clean_name(n), p


def owners(model: nn.Module) -> Dict[str, Tuple[str, nn.Module, str]]:
    """clean parameter name -> (module name, module, parameter name)."""
    out = {}
    for mname, mod in model.named_modules():
        if mname.endswith(".parametrizations") or ".parametrizations." \
                in mname:
            continue
        plist = getattr(mod, "parametrizations", None)
        names = [n for n, _ in mod.named_parameters(recurse=False)]
        if plist is not None:
            names += list(plist.keys())
        for pname in names:
            full = f"{mname}.{pname}" if mname else pname
            out[full] = (mname, mod, pname)
    return out


def stored(mod: nn.Module, pname: str) -> torch.Tensor:
    """``mod.<pname>`` as stored: a sharded parameter's DTensor, not the
    gathered tensor an access makes."""
    if parametrize.is_parametrized(mod, pname):
        return mod.parametrizations[pname].original
    return getattr(mod, pname)


def _jax_perm(mod: nn.Module, pname: str, ndim: int) -> Tuple[int, ...]:
    if pname == "weight" and isinstance(mod, nn.Linear):
        return (1, 0)
    if pname == "weight" and isinstance(mod, (nn.Conv2d, nn.Conv3d)):
        return tuple(range(2, ndim)) + (1, 0)
    return tuple(range(ndim))


def _leaf(mod: nn.Module, pname: str) -> str:
    if isinstance(mod, nn.Embedding):
        return ""
    if pname == "bias":
        return "/bias"
    if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
        return "/kernel"
    return "/scale"


def jax_path(mname: str, mod: nn.Module, pname: str,
             stacks: Mapping[str, int]) -> Tuple[str, int]:
    """(JAX leaf path, layers in its stack or 0) of ``<mname>.<pname>``."""
    for pat, jprefix in _STACKS:
        m = re.match(rf"({pat})\.(\d+)\.(.+)$", mname)
        if m and m.group(1) in stacks:
            sub = m.group(3)
            if sub == "input_layernorm":
                name = "ln" if isinstance(mod, nn.LayerNorm) else "input_ln"
            else:
                name = _LAYER.get(sub, sub.replace(".", "/"))
            return (f"{jprefix}/{name}{_leaf(mod, pname)}",
                    stacks[m.group(1)])
    base = _TOP.get(mname, mname.replace(".", "/"))
    return base + _leaf(mod, pname), 0


def _stacks(model: nn.Module) -> Dict[str, int]:
    """Port name of every ModuleList of one layer class -> its length."""
    return {n: len(m) for n, m in model.named_modules()
            if isinstance(m, nn.ModuleList) and len(m)
            and len({type(x) for x in m}) == 1}


def param_sharding_rules(model: nn.Module, mesh) -> Dict[str, ParamSpec]:
    """{parameter name: :class:`ParamSpec`} of every parameter of
    ``model`` on ``mesh`` (a DeviceMesh or {axis: size}): the JAX rule of
    the parameter's JAX leaf, fitted to the leaf's JAX shape (the stack's
    layer axis first), then carried to the port tensor's dims."""
    stacks = _stacks(model)
    out = {}
    for name, (mname, mod, pname) in owners(model).items():
        p = stored(mod, pname)
        path, n_layers = jax_path(mname, mod, pname, stacks)
        perm = _jax_perm(mod, pname, p.dim())
        piece = tuple(p.shape[i] for i in perm)
        shape = ((n_layers,) + piece) if n_layers else piece
        spec = jax_spec(path, shape, mesh)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        piece_spec = spec
        if n_layers:
            if spec[0] is not None:
                raise ValueError(f"{path}: the layer axis is sharded")
            piece_spec = spec[1:]
        dims = [None] * p.dim()
        for j, entry in enumerate(piece_spec):
            dims[perm[j]] = entry
        out[name] = ParamSpec(path, spec, perm, tuple(dims))
    return out


def placements(spec: ParamSpec):
    """The DTensor placements of ``spec`` on the ("dp", "fsdp", "tp")
    mesh (JAX's ``("fsdp", "tp")`` on one dim nests fsdp outside tp, as
    DTensor nests two ``Shard`` of one dim in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Replicate() if spec.dim(a) is None else Shard(spec.dim(a))
                 for a in AXES)


# ---------------------------------------------------------------------------
# the collectives, as autograd functions


@dataclasses.dataclass(eq=False)
class MeshInfo:
    """The groups of one rank on a ("dp", "fsdp", "tp") mesh: ``size`` and
    ``coord`` by axis, ``group`` by axis (a ProcessGroup)."""

    mesh: object
    size: Dict[str, int]
    coord: Dict[str, int]
    group: Dict[str, object]

    @classmethod
    def of(cls, mesh) -> "MeshInfo":
        return cls(mesh, _sizes(mesh),
                   {a: mesh.get_local_rank(a) for a in AXES},
                   {a: mesh.get_group(a) for a in AXES})

    @property
    def data_rank(self) -> int:
        return self.coord["dp"] * self.size["fsdp"] + self.coord["fsdp"]

    @property
    def data_world(self) -> int:
        return self.size["dp"] * self.size["fsdp"]

    @property
    def world(self) -> int:
        return self.data_world * self.size["tp"]


# A collective over an axis of size 1 is the identity, and is skipped
# (each would be a launch and a copy of the tensor).

def _all_gather(x: torch.Tensor, info: MeshInfo, axis: str,
                dim: int) -> torch.Tensor:
    n = info.size[axis]
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=info.group[axis])
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, info: MeshInfo, axis: str,
                    dim: int) -> torch.Tensor:
    n = info.size[axis]
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=info.group[axis])
    return out.movedim(0, dim)


def _all_reduce(x: torch.Tensor, info: MeshInfo, axis: str) -> torch.Tensor:
    """The sum over ``axis`` in a new tensor (``x``, which autograd may
    share, is left as it is)."""
    if info.size[axis] == 1:
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=info.group[axis])
    return x


def _gather(local: torch.Tensor, info: MeshInfo, spec: ParamSpec,
            tp_local: bool) -> torch.Tensor:
    """A parameter's local shard gathered over tp (unless ``tp_local``)
    and fsdp where ``spec`` splits it; ``local`` itself where nothing
    is split."""
    x = local
    d_tp, d_f = spec.dim("tp"), spec.dim("fsdp")
    if d_tp is not None and not tp_local:
        x = _all_gather(x, info, "tp", d_tp)
    if d_f is not None:
        x = _all_gather(x, info, "fsdp", d_f)
    return x


class _Unshard(torch.autograd.Function):
    """A parameter's local shard -> the parameter whole (``tp_local``
    False) or gathered over fsdp only (True: this tp rank's block).
    Backward: the gradient (a partial sum over the data ranks, equal on
    the tp ranks) reduce-scattered over fsdp where the parameter is split
    there, summed over dp (and over fsdp where it is not split), and
    sliced to this tp rank's block when ``tp_local`` is False.  The node
    keeps the shard, so a saved gathered tensor can be gathered anew
    (:func:`_pack`)."""

    @staticmethod
    def forward(ctx, local, info: MeshInfo, spec: ParamSpec,
                tp_local: bool):
        ctx.info, ctx.spec, ctx.tp_local = info, spec, tp_local
        ctx.local = local
        x = _gather(local, info, spec, tp_local)
        ctx.gathered = x is not local
        ctx.layout = (x.shape, x.stride())
        return x.view_as(x) if x is local else x

    @staticmethod
    def backward(ctx, g):
        info, spec = ctx.info, ctx.spec
        d_tp, d_f = spec.dim("tp"), spec.dim("fsdp")
        if d_f is not None:
            g = _reduce_scatter(g, info, "fsdp", d_f)
        if d_tp is not None and not ctx.tp_local:
            g = g.chunk(info.size["tp"], d_tp)[info.coord["tp"]]
        g = _all_reduce(g, info, "dp")
        if d_f is None:
            g = _all_reduce(g, info, "fsdp")
        return g, None, None, None


@dataclasses.dataclass(eq=False)
class _Regather:
    """What :func:`_pack` keeps of a saved view of a gathered parameter
    (or of its cast to ``dtype``): the gather's node, which holds the
    shard, and the view's layout."""

    node: object
    dtype: Optional[torch.dtype]
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int


# autograd nodes of ops whose output is a view of their input
_VIEW_NODES = frozenset({"TBackward0", "TransposeBackward0", "ViewBackward0",
                         "PermuteBackward0", "AliasBackward0",
                         "SliceBackward0", "ExpandBackward0"})


def _pack(t: torch.Tensor):
    """Autograd's pack hook under :func:`use_mesh`: a tensor saved for the
    backward that is a view of a gathered parameter, or of that
    parameter's cast (autocast's), is kept as a :class:`_Regather` (the
    shard, which the parameter holds anyway), not as the whole weight;
    anything else as it is."""
    node, dtype = t.grad_fn, None
    while type(node).__name__ in _VIEW_NODES:
        node = node.next_functions[0][0]
    if type(node).__name__ == "ToCopyBackward0":
        node, dtype = node.next_functions[0][0], t.dtype
    if not (isinstance(node, _Unshard._backward_cls) and node.gathered):
        return t
    return _Regather(node, dtype, t.size(), t.stride(), t.storage_offset())


def _unpack(x):
    """Autograd's unpack hook: a :class:`_Regather` gathered (and cast)
    again, the same values in the same layout, when the backward reads
    it."""
    if not isinstance(x, _Regather):
        return x
    n = x.node
    with torch.no_grad():
        g = _gather(n.local, n.info, n.spec, n.tp_local)
        if x.dtype is not None:
            g = g.to(x.dtype)
    if (g.shape, g.stride()) != n.layout:
        raise RuntimeError(f"a parameter gathered again is laid out as "
                           f"{(g.shape, g.stride())}, first as {n.layout}")
    return g.as_strided(x.size, x.stride, x.offset)


class _CopyToTP(torch.autograd.Function):
    """Identity; the backward sums the gradient over tp (the input of a
    split linear, equal on the tp ranks, whose gradient each tp rank
    forms in part)."""

    @staticmethod
    def forward(ctx, x, info: MeshInfo):
        ctx.info = info
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.info, "tp"), None


class _SumOverTP(torch.autograd.Function):
    """Sum over tp (a split contraction's partial products); the backward
    is the identity (the sum's gradient is equal on the tp ranks)."""

    @staticmethod
    def forward(ctx, x, info: MeshInfo):
        return _all_reduce(x, info, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherColumns(torch.autograd.Function):
    """This tp rank's output columns [..., n_f * c] (the blocks (f, t) of
    every fsdp f) -> all columns [..., n_f * tp * c] in order; the
    backward takes this rank's columns back."""

    @staticmethod
    def forward(ctx, y, info: MeshInfo, n_f: int):
        ctx.info, ctx.n_f = info, n_f
        tp = info.size["tp"]
        g = _all_gather(y, info, "tp", y.dim() - 1)   # [..., tp * n_f * c]
        lead = g.shape[:-1]
        c = y.shape[-1] // n_f
        return g.reshape(*lead, tp, n_f, c).transpose(-3, -2).reshape(
            *lead, tp * n_f * c)

    @staticmethod
    def backward(ctx, g):
        return (_tp_block(g, ctx.info, ctx.n_f).contiguous(), None, None)


def _tp_block(x: torch.Tensor, info: MeshInfo, n_f: int) -> torch.Tensor:
    """The blocks (f, t) of this tp rank t, for every fsdp f, of the last
    dim of ``x`` (split n_f * tp ways, fsdp outside tp)."""
    tp = info.size["tp"]
    lead = x.shape[:-1]
    c = x.shape[-1] // (n_f * tp)
    return x.reshape(*lead, n_f, tp, c)[..., info.coord["tp"], :].reshape(
        *lead, n_f * c)


# ---------------------------------------------------------------------------
# sharding a model


class _Gathered(nn.Module):
    """The parametrization of a sharded parameter: its DTensor ``original``
    -> the parameter whole, as a plain tensor (:class:`_Unshard`)."""

    def __init__(self, info: MeshInfo, spec: ParamSpec):
        super().__init__()
        self.info, self.spec = info, spec

    def forward(self, original):
        if self.info.world == 1:
            return original.to_local()         # nothing to gather or sum
        return _Unshard.apply(original.to_local(), self.info, self.spec,
                              False)


def _split_linear_forward(self, x: torch.Tensor) -> torch.Tensor:
    """The forward of an ``nn.Linear`` whose weight is split over tp:
    this rank's block of the weight (gathered over fsdp only) against the
    whole input; its share of the output columns gathered over tp (the
    output dim split), or its share of the contraction summed over tp
    (the input dim split)."""
    info, spec = self._mesh_info, self._tp_spec
    w = _Unshard.apply(self.parametrizations.weight.original.to_local(),
                       info, spec, True)
    d = spec.dim("tp")
    n_f = info.size["fsdp"] if spec.dim("fsdp") == d else 1
    x = _CopyToTP.apply(x, info)
    if d == 0:
        b = self.bias
        if b is not None:
            b = _tp_block(_CopyToTP.apply(b, info), info, n_f)
        return _GatherColumns.apply(F.linear(x, w, b), info, n_f)
    y = _SumOverTP.apply(F.linear(_tp_block(x, info, n_f), w), info)
    return y if self.bias is None else y + self.bias.to(y.dtype)


def is_tensor_parallel(module: nn.Module) -> bool:
    """Whether ``module`` is an ``nn.Linear`` that :func:`shard_params`
    split over tp (its forward computes this rank's share)."""
    return getattr(module, "_tp_spec", None) is not None


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s parameters over ``mesh`` in place by
    :func:`param_sharding_rules`: each becomes a DTensor (this rank's
    chunk of the current values) behind a parametrization that gathers it
    at each access, and each ``nn.Linear`` whose weight is split over tp
    (a tp size above 1) computes tensor-parallel.  Every rank must call
    this with the same model.  The mesh is kept as ``model.mesh_info``
    (:func:`mesh_of`).  Returns ``model``."""
    from torch.distributed.tensor import DTensor

    info = MeshInfo.of(mesh)
    specs = param_sharding_rules(model, mesh)
    owned = owners(model)
    for name, spec in specs.items():
        mname, mod, pname = owned[name]
        p = getattr(mod, pname)
        if isinstance(p, DTensor) or parametrize.is_parametrized(mod, pname):
            raise ValueError(f"{name} is already sharded")
        local = local_chunk(p.detach(), info, spec)
        dt = nn.Parameter(DTensor.from_local(local.clone(), mesh,
                                             placements(spec),
                                             run_check=False),
                          requires_grad=p.requires_grad)
        delattr(mod, pname)
        mod.register_parameter(pname, dt)
        parametrize.register_parametrization(mod, pname,
                                             _Gathered(info, spec),
                                             unsafe=True)
        if (pname == "weight" and isinstance(mod, nn.Linear)
                and info.size["tp"] > 1
                and spec.dim("tp") is not None):
            mod._mesh_info, mod._tp_spec = info, spec
            mod.forward = types.MethodType(_split_linear_forward, mod)
    model.mesh_info = info
    return model


def mesh_of(model: nn.Module) -> Optional[MeshInfo]:
    """The :class:`MeshInfo` a model was sharded over, or None."""
    return getattr(model, "mesh_info", None)


def local_chunk(full: torch.Tensor, info: MeshInfo,
                spec: ParamSpec) -> torch.Tensor:
    """This rank's chunk of the whole tensor ``full`` under ``spec``."""
    x = full
    for a in AXES:
        d = spec.dim(a)
        if d is not None:
            x = x.chunk(info.size[a], d)[info.coord[a]]
    return x


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writing it writes the DTensor);
    any other tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def shard_dims(x: torch.Tensor) -> Dict[int, int]:
    """{mesh dim: tensor dim} of the mesh dims whose placement splits
    DTensor ``x`` ({} for any other tensor)."""
    if not is_dtensor(x):
        return {}
    return {i: pl.dim for i, pl in enumerate(x.placements) if pl.is_shard()}


@torch.no_grad()
def sum_over(x: torch.Tensor, mesh, mesh_dims) -> torch.Tensor:
    """``x``, a partial sum of this rank, summed in place over the groups
    of ``mesh``'s dims ``mesh_dims`` (a group of one rank is skipped);
    returns ``x``."""
    for i in sorted(set(mesh_dims)):
        if mesh.size(i) > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(i))
    return x


def like_shards(x: torch.Tensor, mesh, split: Mapping[int, int]):
    """``x``, this rank's piece, as a DTensor of ``mesh`` split by
    ``split`` ({mesh dim: tensor dim}, every other mesh dim replicated);
    ``x`` itself without a mesh."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pls = tuple(Shard(split[i]) if i in split else Replicate()
                for i in range(mesh.ndim))
    return DTensor.from_local(x, mesh, pls, run_check=False)


@torch.no_grad()
def full_tensor(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (every rank must call): all-gathers over
    the mesh dims that split it, innermost first; any other tensor as it
    is."""
    if not is_dtensor(x):
        return x
    mesh, out = x.device_mesh, x.to_local()
    for i in reversed(range(mesh.ndim)):
        pl = x.placements[i]
        if pl.is_shard():
            group = mesh.get_group(i)
            parts = [torch.empty_like(out) for _ in range(mesh.size(i))]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, dim=pl.dim)
        elif not pl.is_replicate():
            return x.full_tensor()
    return out


@torch.no_grad()
def sum_of_squares(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of squares of every entry of ``tensors``, fp32, DTensors
    whole: each local shard's sum, the sums of the tensors split alike
    added, then summed over the mesh dims that split them (one all-reduce
    a dim and kind of split)."""
    groups: Dict[tuple, list] = {}
    for t in tensors:
        key = ((id(t.device_mesh), tuple(t.placements)) if is_dtensor(t)
               else None)
        groups.setdefault(key, []).append(t)
    total = None
    for key, ts in groups.items():
        s = torch.sum(torch.stack([torch.sum(torch.square(local(t).float()))
                                   for t in ts]))
        if key is not None:
            mesh, pls = ts[0].device_mesh, key[1]
            for i, pl in enumerate(pls):
                if pl.is_shard():
                    dist.all_reduce(s, group=mesh.get_group(i))
                elif not pl.is_replicate():
                    raise ValueError(f"a {pl} DTensor has no whole value")
        total = s if total is None else total + s
    return total


@torch.no_grad()
def to_full(obj):
    """``obj`` (a state: nested dicts, lists and tuples) with every DTensor
    gathered whole onto the CPU; every rank must call."""
    if is_dtensor(obj):
        return full_tensor(obj).cpu()
    if isinstance(obj, dict):
        return {k: to_full(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_full(v) for v in obj)
    return obj


@torch.no_grad()
def shard_like(full, like):
    """``full`` (a state of :func:`to_full`'s form) as ``like``'s layout:
    where ``like`` holds a DTensor, this rank's chunk of ``full``'s tensor
    as a DTensor of the same mesh and placements (shapes checked first)."""
    from torch.distributed.tensor import DTensor

    if isinstance(full, DTensor):
        return full
    if isinstance(like, DTensor):
        if not torch.is_tensor(full) or tuple(full.shape) != tuple(
                like.shape):
            raise ValueError(f"state of shape "
                             f"{tuple(getattr(full, 'shape', ()))} for a "
                             f"DTensor of {tuple(like.shape)}")
        piece = full
        mesh = like.device_mesh
        for a, pl in zip(mesh.mesh_dim_names, like.placements):
            if pl.is_shard():
                piece = piece.chunk(mesh.size(mesh.mesh_dim_names.index(a)),
                                    pl.dim)[mesh.get_local_rank(a)]
        return DTensor.from_local(
            piece.to(device=like.device, dtype=like.dtype).contiguous(),
            mesh, like.placements, run_check=False)
    if isinstance(like, dict) and isinstance(full, dict):
        return {k: shard_like(v, like[k]) if k in like else v
                for k, v in full.items()}
    if isinstance(like, (list, tuple)) and isinstance(full, (list, tuple)) \
            and len(like) == len(full):
        return type(full)(shard_like(f, l) for f, l in zip(full, like))
    return full


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The unsharded model's state dict (its names, every parameter
    whole, on the CPU for a sharded model); every rank must call."""
    if mesh_of(model) is None:
        return model.state_dict()
    return {clean_name(n): to_full(t) for n, t in model.state_dict().items()}


@torch.no_grad()
def load_full_state_dict(model: nn.Module,
                         sd: Mapping[str, torch.Tensor]) -> None:
    """Load an unsharded state dict (:func:`full_state_dict`'s form) into
    ``model``, sharded or not; every shape is checked before any copy."""
    if mesh_of(model) is None:
        model.load_state_dict(sd)
        return
    live = model.state_dict()
    want = {clean_name(n): n for n in live}
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:3]}, "
                       f"unexpected {unexpected[:3]}")
    pieces = {want[k]: shard_like(v, live[want[k]]) for k, v in sd.items()}
    for n, t in pieces.items():
        if tuple(t.shape) != tuple(live[n].shape):
            raise ValueError(f"{clean_name(n)}: {tuple(t.shape)} for "
                             f"{tuple(live[n].shape)}")
    for n, t in pieces.items():
        local(live[n]).copy_(local(t))


# ---------------------------------------------------------------------------
# batches and the losses of a global batch

_ambient: list = []


@contextlib.contextmanager
def use_mesh(info: Optional[MeshInfo]):
    """Make ``info`` (a sharded model's ``mesh_info``) the mesh that
    :func:`global_mean` reads in a step (as ``jax.set_mesh`` does for
    JAX's ``constrain``); None leaves the ambient mesh unset.  Over more
    than one rank, a gathered parameter that autograd saves for the
    backward is kept as its shard and gathered again when the backward
    reads it (:func:`_pack`; FSDP's reshard after forward), so a step
    holds one whole weight at a time, not every layer's until the
    backward.  A remat region's own hooks take precedence inside it."""
    _ambient.append(info)
    try:
        if info is not None and info.world > 1:
            with torch.autograd.graph.saved_tensors_hooks(_pack, _unpack):
                yield info
        else:
            yield info
    finally:
        _ambient.pop()


def current_mesh() -> Optional[MeshInfo]:
    return _ambient[-1] if _ambient else None


def is_writer() -> bool:
    """Whether this process writes the files of a run: rank 0 of the
    process group, or the only process."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def load_config_mesh(config):
    """(mesh, device) of a CLI run.  A run launched by torchrun
    (``WORLD_SIZE`` set) or inside a process group joins it on the
    config's ``device`` (:func:`init_distributed`) and makes the mesh of
    its ``parallel: {dp, fsdp, tp}`` block (JAX ``main``'s
    ``make_mesh(dp=par.get("dp"), fsdp=..., tp=...)``, dp filling the
    world); the loaders read the data rank of the model sharded over it
    (``data/loader.py::data_shard``).  A run with neither is one process: (None, the config's
    device), the block's default (dp null, fsdp 1, tp 1) being the
    unsharded model; a block that asks for more ranks raises."""
    par = config.get("parallel") or {}
    device = config.get("device")
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        want = (par.get("dp") or 1) * (par.get("fsdp") or 1) * (
            par.get("tp") or 1)
        if want > 1:
            raise ValueError(f"parallel: {dict(par)} asks for {want} ranks; "
                             f"launch the run with torchrun")
        return None, device
    device = init_distributed(device)
    mesh = make_mesh(dp=par.get("dp"), fsdp=par.get("fsdp", 1),
                     tp=par.get("tp", 1))
    return mesh, device


def shard_batch(batch, mesh):
    """This rank's rows of ``batch`` (a tensor, an array, a list of
    strings, or nested dicts / lists / tuples of them): the leading axis
    split over ("dp", "fsdp") in
    that order, as JAX's ``P(("dp", "fsdp"))``; the tp ranks of a
    coordinate get the same rows.  The leading axis must divide."""
    info = mesh if isinstance(mesh, MeshInfo) else MeshInfo.of(mesh)
    r, n = info.data_rank, info.data_world

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        rows = isinstance(x, list) and x and isinstance(x[0], (str, bytes))
        if isinstance(x, (list, tuple)) and not rows:
            return type(x)(take(v) for v in x)
        if rows or torch.is_tensor(x) or isinstance(x, np.ndarray):
            if len(x) % n:
                raise ValueError(f"batch axis {len(x)} does not divide "
                                 f"over {n} data ranks")
            k = len(x) // n
            return x[r * k:(r + 1) * k]
        return x

    return take(batch)


def batch_sharding(mesh) -> tuple:
    """The placements of a batch on ``mesh``: JAX's ``P(("dp", "fsdp"))``,
    the rows split over dp then fsdp, replicated over tp."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Shard(0), Replicate())


def replicated(mesh) -> tuple:
    """The placements of a replicated value on ``mesh`` (JAX ``P()``)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * len(AXES)


def constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """JAX's ``constrain`` (a sharding hint to the partitioner, no numbers
    of its own): the identity here, where every activation is a plain
    tensor of this rank's rows and the whole width."""
    return x


def _leaves(x) -> Iterator:
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)) and not (
            x and isinstance(x[0], (str, bytes))):
        for v in x:
            yield from _leaves(v)
    elif x is not None:
        yield x


def check_same_rows(inputs, info: Optional[MeshInfo]) -> None:
    """Raise ValueError unless the tp ranks of this (dp, fsdp) coordinate
    hold the same ``inputs`` (tensors, arrays and lists of strings, nested
    in dicts, lists and tuples).  A split linear joins the columns that
    each tp rank computes from its own input, so rows that differ over tp
    would make a wrong result, silently: a loader built without the
    model's data shard (``data/loader.py::data_shard``) does that.  One
    all-gather over tp of a fingerprint (each leaf's length and a
    row-weighted fp64 sum; a string list's crc32); nothing at tp 1."""
    import zlib

    if info is None or info.size["tp"] == 1:
        return
    fp = []
    for x in _leaves(inputs):
        if isinstance(x, (list, tuple)):
            fp += [len(x), zlib.crc32("\0".join(map(str, x)).encode())]
            continue
        t = torch.as_tensor(x).detach()
        t = t.reshape(-1, 1) if t.dim() < 2 else t.flatten(1)
        w = torch.arange(1, t.shape[0] + 1, dtype=torch.float64,
                         device=t.device)
        fp += [t.shape[0], t.numel(), float((t.double().sum(1) * w).sum())]
    dev = "cuda" if info.mesh.device_type == "cuda" else "cpu"
    mine = torch.tensor(fp, dtype=torch.float64, device=dev)
    every = _all_gather(mine[None], info, "tp", 0)
    if not bool((every == mine).all()):
        raise ValueError(
            f"the tp ranks of data rank {info.data_rank} hold different "
            f"rows; each (dp, fsdp) coordinate's tp ranks must read the same "
            f"rows (build the loaders with data_shard(model))")


def global_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``total / max(count, 1)`` over the global batch: under an ambient
    mesh :func:`use_mesh` ``count`` (this rank's) is summed over the data
    ranks first, so ``total`` (this rank's) over it is this rank's share
    of the global mean and the shares' gradients, summed by the parameter
    gathers' backward, are the global mean's."""
    info = current_mesh()
    if info is not None and info.data_world > 1:
        count = count.detach()
        for a in DATA_AXES:
            count = _all_reduce(count, info, a)
    return total / count.clamp(min=1)


@torch.no_grad()
def data_sum(x: torch.Tensor, info: Optional[MeshInfo]) -> torch.Tensor:
    """``x`` summed over the data ranks (a loss share of
    :func:`global_mean` -> the loss); ``x`` itself without a mesh."""
    if info is None:
        return x
    x = x.detach()
    for a in DATA_AXES:
        x = _all_reduce(x, info, a)
    return x


def data_mean(x: torch.Tensor, info: Optional[MeshInfo]) -> torch.Tensor:
    """The mean over the data ranks of a per-rank mean over equal rows."""
    if info is None:
        return x
    return data_sum(x, info) / info.data_world
