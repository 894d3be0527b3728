"""The remat policies of showo_tpu_torch (``utils/remat.py``) on tiny
Phi, Qwen2, DiT and SigLIP stacks (2 layers, fp32, the CPU), against the
JAX package's policies (``showo_tpu/utils/remat.py``).

For each of the seven policies:

* the loss and every gradient equal ``none``'s (rtol 1e-6);
* the forward products the backward recomputes are the ones JAX's policy
  recomputes: a ``TorchDispatchMode`` counts the ``mm`` / ``addmm`` calls
  of the backward whose right operand is a layer weight transposed (the
  forward's ``x @ W^T``; the gradient products read ``W`` itself or the
  activations), and their output widths, two layers' worth, must be
  twice the widths of the dot products without batch dims that the JAX
  policy adds to the jaxpr of the same model's gradient (one scanned
  layer) over ``none``'s.  Products with batch dims (the dense
  attention's) are outside the count, as they are outside
  ``dots_with_no_batch_dims_saveable``.

Phi also runs on the ``trainable`` route (kernel 7's plain version), and
an unknown policy raises.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore
from torch.utils._python_dispatch import TorchDispatchMode

from showo_tpu.models import phi as jphi
from showo_tpu.show_o2 import dit as jdit
from showo_tpu.show_o2 import qwen2 as jqwen
from showo_tpu.show_o2 import siglip as jsig
from showo_tpu_torch.models import phi as tphi
from showo_tpu_torch.show_o2 import dit as tdit
from showo_tpu_torch.show_o2 import qwen2 as tqwen
from showo_tpu_torch.show_o2 import siglip as tsig
from showo_tpu_torch.utils import remat

torch.set_num_threads(1)

POLICIES = ("none", "full", "dots", "qkv", "qkv_fc1", "qkv_attn",
            "qkv_fc1_attn")
B, S, D, F, L = 1, 12, 64, 96, 2
TOL = dict(rtol=1e-6, atol=0)


def _jax_walk(jaxpr, out):
    for e in jaxpr.eqns:
        if e.primitive.name == "dot_general":
            (_, _), (lb, _) = e.params["dimension_numbers"]
            if not lb:
                out[e.outvars[0].aval.shape[-1]] += 1
        for v in e.params.values():
            for j in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(j, jcore.ClosedJaxpr):
                    _jax_walk(j.jaxpr, out)
                elif isinstance(j, jcore.Jaxpr):
                    _jax_walk(j, out)


def _jax_recomputed(loss, params, policy):
    """Widths of the non-batch products JAX's ``policy`` adds to the
    gradient's jaxpr (one scanned layer) over ``none``."""
    def count(p):
        c = Counter()
        _jax_walk(jax.make_jaxpr(jax.grad(lambda x: loss(x, p)))(
            params).jaxpr, c)
        return c
    return count(policy) - count("none")


class _Recomputed(TorchDispatchMode):
    """Counts mm / addmm whose right operand is a weight of ``weights``
    transposed: the forward's products, by output width."""

    def __init__(self, weights):
        super().__init__()
        self.ptrs = {w.data_ptr(): w.shape for w in weights}
        self.widths = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            m2 = args[-1]
            if (m2.dim() == 2 and m2.stride(0) == 1
                    and self.ptrs.get(m2.data_ptr()) == m2.t().shape):
                self.widths[m2.shape[1]] += 1
        return func(*args, **(kwargs or {}))


def _port_run(model, loss, policy):
    """(loss, grads, recomputed widths) of the port under ``policy``."""
    params = [p for p in model.parameters() if p.requires_grad]
    weights = [p for p in params if p.dim() == 2]
    out = loss(model, policy)
    mode = _Recomputed(weights)
    with mode:
        grads = torch.autograd.grad(out, params)
    return out.detach(), grads, mode.widths


def _check(model, loss, jloss, jparams):
    base_loss, base_grads, base_w = _port_run(model, loss, "none")
    assert not base_w
    for policy in POLICIES[1:]:
        got_loss, grads, widths = _port_run(model, loss, policy)
        np.testing.assert_allclose(got_loss.numpy(), base_loss.numpy(),
                                   rtol=1e-6)
        for g, b in zip(grads, base_grads):
            np.testing.assert_allclose(g.numpy(), b.numpy(), **TOL,
                                       err_msg=policy)
        want = _jax_recomputed(jloss, jparams, policy)
        assert widths == Counter({w: L * n for w, n in want.items()}), (
            policy, widths, want)


def _ids(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


@pytest.mark.parametrize("route", ["dense", "trainable"])
def test_phi(route):
    cfg = tphi.PhiConfig(vocab_size=80, hidden_size=D, intermediate_size=F,
                         num_layers=L, num_heads=4)
    model = tphi.Phi(cfg).init_random(torch.Generator().manual_seed(0))
    ids = torch.as_tensor(_ids(80))
    meta = None
    if route == "trainable":
        z = torch.zeros((B, S), dtype=torch.int32)
        meta = ("trainable", z, z, torch.full((B,), -1, dtype=torch.int32),
                torch.zeros((B,), dtype=torch.int32))

    def loss(m, policy):
        logits, _ = m(ids, attn_meta=meta, remat=policy)
        return (logits ** 2).mean()

    jcfg = jphi.PhiConfig(vocab_size=80, hidden_size=D, intermediate_size=F,
                          num_layers=1, num_heads=4)
    jp = jphi.init_phi_params(jcfg, jax.random.PRNGKey(0))
    jids = jnp.asarray(_ids(80))

    def jloss(p, policy):
        return (jphi.phi_forward(jcfg, p, jids, remat=policy)[0] ** 2).mean()

    _check(model, loss, jloss, jp)


def test_qwen2():
    kw = dict(vocab_size=80, hidden_size=D, intermediate_size=F,
              num_heads=4, num_kv_heads=2, head_dim=16)
    model = tqwen.Qwen2(tqwen.Qwen2Config(num_layers=L, **kw))
    tqwen.init_normal(model, torch.Generator().manual_seed(1))
    ids = torch.as_tensor(_ids(80, 1))

    def loss(m, policy):
        return (m(ids, remat=policy)[0] ** 2).mean()

    jcfg = jqwen.Qwen2Config(num_layers=1, **kw)
    jp = jqwen.init_qwen2_params(jcfg, jax.random.PRNGKey(1))
    jids = jnp.asarray(_ids(80, 1))

    def jloss(p, policy):
        return (jqwen.qwen2_forward(jcfg, p, jids, remat=policy)[0]
                ** 2).mean()

    _check(model, loss, jloss, jp)


def test_dit():
    kw = dict(hidden_size=D, intermediate_size=F, num_heads=4,
              num_kv_heads=2, head_dim=16)
    cfg = tdit.DiffusionHeadConfig(num_layers=L, **kw)
    layers = torch.nn.ModuleList(tdit.ModulatedAttentionBlock(cfg)
                                 for _ in range(L))
    tqwen.init_normal(layers, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    h = rng.normal(size=(B, S, D)).astype(np.float32)
    ada = rng.normal(size=(B, D)).astype(np.float32)
    mp = np.array([[[2, 8]]], np.int32)

    def loss(m, policy):
        out = tdit.dit_forward(cfg, m, torch.as_tensor(h),
                               torch.as_tensor(ada), None,
                               torch.as_tensor(mp), remat=policy)
        return (out ** 2).mean()

    jcfg = jdit.DiffusionHeadConfig(num_layers=1, **kw)
    jp = jdit.init_dit_params(jcfg, jax.random.PRNGKey(2))
    jp["layers"]["adaln"]["kernel"] = 0.1 * jax.random.normal(
        jax.random.PRNGKey(3), jp["layers"]["adaln"]["kernel"].shape)

    def jloss(p, policy):
        return (jdit.dit_forward(jcfg, p, jnp.asarray(h), jnp.asarray(ada),
                                 None, jnp.asarray(mp), remat=policy)
                ** 2).mean()

    _check(layers, loss, jloss, jp)


def test_siglip():
    kw = dict(hidden_size=D, intermediate_size=F, num_heads=4,
              num_positions=16)
    enc = tsig.SiglipEncoder(tsig.SigLipConfig(num_layers=L, **kw))
    tqwen.init_normal(enc, torch.Generator().manual_seed(4))
    x = np.random.default_rng(4).normal(size=(B, S, D)).astype(np.float32)

    def loss(m, policy):
        return (m(torch.as_tensor(x), remat=policy) ** 2).mean()

    jcfg = jsig.SigLipConfig(num_layers=1, **kw)
    jp = jsig.init_siglip_params(jcfg, jax.random.PRNGKey(4))

    def jloss(p, policy):
        return (jsig.siglip_encode(jcfg, p, jnp.asarray(x), remat=policy)
                ** 2).mean()

    _check(enc, loss, jloss, jp)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy 'qkv_mlp'"):
        remat.wrap_remat(lambda x: x, "qkv_mlp")
    assert remat.check_policy(True) == "full"
    assert remat.check_policy(None) == "none"


@pytest.mark.parametrize("policy", ["full", "dots", "qkv_fc1_attn"])
def test_a_failed_forward_frees_its_activations(policy, monkeypatch):
    """A forward that raises inside a layer's remat region (as an
    out-of-memory error does on the card) leaves nothing alive once the
    error is dropped: the kept outputs are stashed without their graph,
    so no reference cycle runs through the checkpoint's saved-tensor
    hooks, which Python's collector cannot follow."""
    import gc
    import weakref

    kw = dict(vocab_size=80, hidden_size=D, intermediate_size=F,
              num_heads=4, num_kv_heads=2, head_dim=16)
    model = tqwen.Qwen2(tqwen.Qwen2Config(num_layers=3, **kw))
    tqwen.init_normal(model, torch.Generator().manual_seed(5))
    alive = []
    for layer in model.model.layers:
        layer.register_forward_hook(
            lambda m, i, o: alive.append(weakref.ref(o)))
    calls = []
    forward = tqwen.SwiGLU.forward

    def failing(self, x, tail=False):
        calls.append(1)
        if len(calls) == 2:          # the second layer's MLP
            raise torch.cuda.OutOfMemoryError("planted")
        return forward(self, x, tail)

    monkeypatch.setattr(tqwen.SwiGLU, "forward", failing)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        model(torch.as_tensor(_ids(80, 5)), remat=policy)
    gc.collect()
    assert len(alive) == 1 and alive[0]() is None
