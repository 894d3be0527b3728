"""Per-rank bytes of a Show-o2 stage-1 training state on an fsdp mesh,
reckoned on the meta device in one process.

    python tests/_reckon_state.py CONFIG FSDP [FSDP ...]

For each fsdp size: a fake process group of that many ranks (collectives
are no-ops; nothing is allocated), the config's model on the meta device
in fp32 (the trainer's master weights), sharded by ``parallel/mesh.py``'s
rules, its frozen parameters frozen, then the stage-1 optimizer of each
of ``adamw`` (the two fp32 moments of the port's ``torch.optim.AdamW``,
read after one step on zero gradients), ``adamw_bf16`` and ``adafactor``
built on it.  Prints one JSON line: {fsdp: {optimizer: {"param_bytes",
"state_bytes" (this rank's), "big" (state tensors of 8 MiB or more,
whole), "big_kept_split" (of those, the ones that keep an axis the mesh
splits), "big_split_like_param" (of those, split over as many ranks as
their parameter), "kept_split" and "kept_split_like_param" (the same
over every state tensor)}}}.  A CPU reckoning of shapes, not a device
measurement.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from showo_tpu_torch.config import load_config  # noqa: E402
from showo_tpu_torch.inference_t2i_v2 import build_showo2_config  # noqa
from showo_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from showo_tpu_torch.show_o2 import train_stage_one as t1  # noqa: E402
from showo_tpu_torch.show_o2.showo2 import Showo2  # noqa: E402
from showo_tpu_torch.training.optim import factored_dims  # noqa: E402

OPTIMIZERS = ("adamw", "adamw_bf16", "adafactor")
BIG = 8 * 2 ** 20


def _nbytes(t: torch.Tensor, piece: bool) -> int:
    x = tmesh.local(t) if piece else t
    return x.numel() * x.element_size()


def _state(name: str, opt):
    """(state tensor, its parameter, whether it keeps an axis that the
    mesh splits) of the optimizer ``name``."""
    if name == "adamw":
        # one step on zero gradients makes the moments as training does
        for p in opt.params:
            p.grad = torch.zeros_like(p)
        opt.adamw.step()
        return [(opt.adamw.state[p][k], p, bool(tmesh.shard_dims(p)))
                for p in opt.params for k in ("exp_avg", "exp_avg_sq")]
    inner = opt.inner
    if name == "adamw_bf16":
        return [(x, p, bool(tmesh.shard_dims(p)))
                for p, x in zip(inner.params * 2, inner.mu + inner.nu)]
    out = []
    for t, v in zip(inner.tensors, inner.v):
        # a row or column mean over the split axis is whole
        dims = factored_dims(t.shape) or (None, None)
        out += [(x, t.params[0], bool(set(t.split.values()) - {d}))
                for x, d in zip(v, dims[::-1])]
    return out


def _split_like(x: torch.Tensor, p: torch.Tensor) -> bool:
    """Whether state ``x`` is split over as many ranks as parameter
    ``p``."""
    return (tmesh.local(x).numel() * p.numel()
            == x.numel() * tmesh.local(p).numel())


def reckon(config_path: str, fsdp: int) -> dict:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=fsdp)
    try:
        config = load_config(config_path)
        model = Showo2(build_showo2_config(config), device="meta")
        tmesh.shard_params(model, tmesh.make_mesh(1, fsdp, 1))
        frozen = list(config.model.get("frozen_params", []) or [])
        base = t1.stage1_config(config)
        param_bytes = sum(_nbytes(p, True) for p in model.parameters())
        out = {}
        for name in OPTIMIZERS:
            opt = t1.make_stage1_optimizer(
                dataclasses.replace(base, optimizer=name), model, frozen)
            state = _state(name, opt)
            big = [(x, p, kept) for x, p, kept in state
                   if _nbytes(x, False) >= BIG]
            out[name] = {
                "trained": sum(p.numel() for p in opt.params),
                "param_bytes": param_bytes,
                "state_bytes": sum(_nbytes(x, True) for x, _, _ in state),
                "state_bytes_whole": sum(_nbytes(x, False)
                                         for x, _, _ in state),
                "big": len(big),
                "big_kept_split": sum(kept for _, _, kept in big),
                "big_split_like_param": sum(
                    kept and _split_like(x, p) for x, p, kept in big),
                "kept_split": sum(kept for _, _, kept in state),
                "kept_split_like_param": sum(
                    kept and _split_like(x, p) for x, p, kept in state)}
        return out
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    path, sizes = sys.argv[1], [int(s) for s in sys.argv[2:]]
    print(json.dumps({s: reckon(path, s) for s in sizes}))
