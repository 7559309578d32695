"""The selective remat modes (``torchft_tpu_torch/models/remat.py``) against
the JAX package's (``torchft_tpu/models/remat.py``), on the CPU.

For each mode the debug Llama in f32, through the plain versions of the
fused attention (``attention="splash"`` on CPU tensors runs them through
the ``torchft_tpu_torch::attention_fwd`` / ``::attention_bwd`` ops) and
through the materialized path, gives ``llama_loss(..., remat=mode)``'s loss
and gradients within rtol 1e-4 / atol 1e-5, and the port's own no-remat
gradients bit for bit. A ``TorchDispatchMode`` counts the operators that
ran: the attention forward once per layer and step under "none", "dots"
and "attn" and twice under "full"; "dots" recomputes no unbatched product
and "attn" every one. The ops pass ``torch.library.opcheck``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torchft_tpu.models import llama as jl
from torchft_tpu.models import remat as jremat
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import llama as tl
from torchft_tpu_torch.models import moe as tm
from torchft_tpu_torch.models import remat as tremat
from torchft_tpu_torch.ops import attention as tattn

RTOL, ATOL = 1e-4, 1e-5
MODES = ["none", "dots", "attn", "full"]
FWD = "torchft_tpu_torch.attention_fwd.default"
BWD = "torchft_tpu_torch.attention_bwd.default"
ATTN_OUT = "torchft_tpu_torch.attn_out.default"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _OpCounts(TorchDispatchMode):
    """How many times each operator ran below autograd."""

    def __init__(self) -> None:
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _setup():
    cfg = jl.CONFIGS["debug"]
    params = jl.llama_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    targets = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return cfg, params, tokens, targets


def _port_step(model, tokens, targets):
    """(loss, grads by name, operator counts) of one forward + backward."""
    model.zero_grad(set_to_none=True)
    with _OpCounts() as ops:
        loss = model.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
        loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}, ops.counts


@pytest.mark.parametrize("attention", ["splash", "xla"])
@pytest.mark.parametrize("mode", MODES)
def test_each_mode_is_the_reference_and_keeps_the_no_remat_grads(mode, attention):
    cfg, params, tokens, targets = _setup()
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jl.llama_loss(p, jnp.asarray(tokens), jnp.asarray(targets), cfg, remat=mode))(
        params)
    model = tl.Llama(tl.CONFIGS["debug"], device="cpu", attention=attention, remat="none")
    model.load_state_dict(convert.llama_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                               params)))
    base_loss, base_grads, _ = _port_step(model, tokens, targets)
    model.remat = mode
    loss, grads, _ = _port_step(model, tokens, targets)

    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=RTOL, atol=ATOL)
    host = jax.tree_util.tree_map(np.asarray, ref_grads)
    want = convert.llama_params_from_jax(host)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert torch.equal(loss, base_loss)
    for name, g in grads.items():
        assert torch.equal(g, base_grads[name]), name


@pytest.mark.parametrize("mode,forwards", [("none", 1), ("dots", 1), ("attn", 1), ("full", 2),
                                           (False, 1), (True, 2)])
def test_the_attention_forward_runs_once_per_layer_but_under_full(mode, forwards):
    """The fused forward per layer and step (its backward once), and the
    unbatched products: "dots" saves them (as many as without remat),
    "attn" and "full" run each forward product again in backward."""
    cfg, params, tokens, targets = _setup()
    model = tl.Llama(tl.CONFIGS["debug"], device="cpu", attention="splash", remat="none")
    model.load_state_dict(convert.llama_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                               params)))
    _, _, base = _port_step(model, tokens, targets)
    model.remat = mode
    _, _, ops = _port_step(model, tokens, targets)
    assert ops[FWD] == forwards * cfg.n_layers
    assert ops[BWD] == cfg.n_layers
    mm = "aten.mm.default"
    if tremat.resolve_remat(mode) in ("none", "dots"):
        assert ops[mm] == base[mm]
    else:
        assert ops[mm] > base[mm]


@pytest.mark.parametrize("mode,tags", [("none", 1), ("dots", 1), ("attn", 1), ("full", 2)])
def test_the_materialized_attention_is_named_by_its_tag(mode, tags):
    """The plain-op path ends in ``attn_out``, which "dots" and "attn"
    save: it runs once per layer unless the whole layer is recomputed."""
    cfg, params, tokens, targets = _setup()
    model = tl.Llama(tl.CONFIGS["debug"], device="cpu", attention="xla", remat=mode)
    model.load_state_dict(convert.llama_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                               params)))
    _, _, ops = _port_step(model, tokens, targets)
    assert ops[ATTN_OUT] == tags * cfg.n_layers
    assert FWD not in ops


def test_the_tag_is_left_out_where_autograd_does_not_record():
    """Without a graph no policy reads the name, so inference pays no copy:
    under ``no_grad`` the materialized path gives the same logits without
    ``attn_out``."""
    cfg, params, tokens, _ = _setup()
    model = tl.Llama(tl.CONFIGS["debug"], device="cpu", attention="xla")
    model.load_state_dict(convert.llama_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                               params)))
    t = torch.from_numpy(tokens).long()
    with torch.no_grad(), _OpCounts() as ops:
        logits = model(t)
    assert ATTN_OUT not in ops.counts
    assert torch.equal(logits, model(t).detach())


def test_dots_recomputes_the_batched_expert_products():
    """In the MoE, "dots" saves the router's and attention's unbatched
    products but recomputes the experts' batched ones (``bmm``), as the
    reference's ``dots_with_no_batch_dims_saveable``."""
    model = tm.MoE(tm.MOE_CONFIGS["debug"], device="cpu", attention="splash", remat="none")
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = np.random.RandomState(1).randint(0, 256, (2, 16))
    _, base_grads, base = _port_step(model, tokens, tokens)
    model.remat = "dots"
    _, grads, ops = _port_step(model, tokens, tokens)
    assert ops["aten.mm.default"] == base["aten.mm.default"]
    assert ops["aten.bmm.default"] > base["aten.bmm.default"]
    assert ops[FWD] == model.cfg.n_layers
    for name, g in grads.items():
        assert torch.equal(g, base_grads[name]), name


@pytest.mark.parametrize("bad", ["partial", "DOTS", 2, None])
def test_an_unknown_mode_raises_as_the_reference(bad):
    with pytest.raises(ValueError, match="unknown remat mode"):
        jremat.remat_wrap(lambda h, p: (h, None), bad)
    with pytest.raises(ValueError, match="unknown remat mode"):
        tremat.remat_wrap(lambda h: h, bad)
    with pytest.raises(ValueError, match="unknown remat mode"):
        tl.Llama(tl.CONFIGS["debug"], device="cpu", remat=bad)


def test_the_modes_and_name_are_the_reference():
    assert tremat.ATTN_OUT_NAME == jremat.ATTN_OUT_NAME
    assert set(tremat.REMAT_MODES) == {"none", "dots", "attn", "full"}
    # the defaults: llama_loss "dots", moe_forward full (True)
    assert tl.Llama(tl.CONFIGS["debug"], device="cpu").remat == "dots"
    assert tremat.resolve_remat(tm.MoE(tm.MOE_CONFIGS["debug"], device="cpu").remat) == "full"


def _qkv(hq=4, hkv=2, requires_grad=True):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 16, h, 8, generator=g).requires_grad_(requires_grad)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("impl,sm_scale", [("splash", 1.0), ("flash", 8 ** -0.5)])
def test_the_attention_ops_pass_opcheck(impl, sm_scale):
    """Schema, autograd registration, fake tensors and AOT dispatch of the
    CPU registrations."""
    q, k, v = _qkv()
    torch.library.opcheck(tattn.attention_fwd_op, (q, k, v, sm_scale, impl, False))
    with torch.no_grad():
        o, lse = tattn.attention_fwd_op(q, k, v, sm_scale, impl, False)
    do = torch.randn_like(o)
    torch.library.opcheck(tattn.attention_bwd_op,
                          tuple(x.detach() for x in (q, k, v)) + (o, lse, do, sm_scale, impl,
                                                                  False))
    torch.library.opcheck(tattn.attn_out, (torch.randn(2, 16, 4, 8, requires_grad=True),))


@pytest.mark.parametrize("impl", ["splash", "flash"])
def test_the_ops_are_the_plain_versions_on_the_cpu(impl):
    """On CPU tensors the ops run the plain versions: the forward's (o, lse)
    and the backward's gradients bit for bit, and no kernel launches."""
    q, k, v = _qkv(requires_grad=False)
    sm = 1.0 if impl == "splash" else 8 ** -0.5
    tattn.reset_launches()
    o, lse = tattn.attention_fwd_op(q, k, v, sm, impl, False)
    po, plse = tattn.attention_fwd_plain(q, k, v, sm, impl == "splash")
    assert torch.equal(o, po) and torch.equal(lse, plse)
    do = torch.randn_like(o)
    dq, dk, dv = tattn.attention_bwd_op(q, k, v, o, lse, do, sm, impl, False)
    delta = tattn.attention_delta(o, do)
    assert torch.equal(dq, tattn.attention_dq_plain(q, k, v, lse, delta, do, sm))
    pdk, pdv = tattn.attention_dkv_plain(q, k, v, lse, delta, do, sm)
    assert torch.equal(dk, pdk) and torch.equal(dv, pdv)
    assert not any(tattn.LAUNCHES.values())


def test_dots_trains_as_full_through_a_crash():
    """The Llama trainer under ``remat="dots"``: the same commit sequence as
    under "full" through a crash after step 2's backward pass, and the same
    parameters, bit for bit."""
    from torchft_tpu_torch import train
    from torchft_tpu_torch.train import Fault

    runs = {}
    for mode in ("full", "dots"):
        cfg = train.TrainConfig(config="debug", steps=4, seq_len=16, quantize=False,
                                transport="http", remat=mode,
                                faults=(Fault(1, 2, "crash", at="backward"),))
        results = train.run_replicas(cfg, "cpu")
        votes = [[(e["step"], e["committed"]) for e in r["log"]] for r in results]
        runs[mode] = (votes, results[0]["params"])
    assert runs["dots"][0] == runs["full"][0]
    assert any(not c for v in runs["full"][0] for _, c in v), "a step must be discarded"
    for k, v in runs["full"][1].items():
        assert torch.equal(v, runs["dots"][1][k]), k
