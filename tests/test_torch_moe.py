"""The port's MoE (``torchft_tpu_torch/models/moe.py``) against the JAX
package's (``torchft_tpu/models/moe.py``), on the CPU.

The reference's own cases (``tests/test_moe.py``: dispatch, capacity,
aux loss, the single-expert FFN) run on both packages. Routing is exact
against ``_route`` (experts, queue positions, what fits), gates and the aux
loss at f32 rounding; the loss, logits and every gradient of the debug
config in f32 agree with ``moe_loss`` within rtol 1e-4 / atol 1e-5 (the
bar of ``tests/test_torch_llama.py``), also with a capacity factor that
drops tokens; bf16 losses within 2e-2. The trainer runs the MoE as two
replica threads through a crash and an HTTP heal. Expert parallelism is
held in ``tests/test_torch_moe_parallel.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import moe as jm
from torchft_tpu_torch import convert
from torchft_tpu_torch.models import moe as tm

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ref:
    """The reference's routing functions on numpy inputs."""

    name = "ref"

    @staticmethod
    def dispatch(probs, top_k, capacity):
        combine, dispatch, aux = jm._top_k_dispatch(jnp.asarray(probs), top_k, capacity)
        return np.asarray(combine), np.asarray(dispatch), float(aux)

    @staticmethod
    def ffn(x, router, wg, wu, wd, cfg_kwargs):
        cfg = jm.MoEConfig(dtype=jnp.float32, **cfg_kwargs)
        out, _ = jm.moe_ffn(*(jnp.asarray(a) for a in (x, router, wg, wu, wd)), cfg)
        return np.asarray(out)


class _Port:
    name = "port"

    @staticmethod
    def dispatch(probs, top_k, capacity):
        combine, dispatch, aux = tm._top_k_dispatch(torch.from_numpy(np.asarray(probs)), top_k,
                                                    capacity)
        return combine.numpy(), dispatch.numpy(), float(aux)

    @staticmethod
    def ffn(x, router, wg, wu, wd, cfg_kwargs):
        cfg = tm.MoEConfig(dtype=torch.float32, **cfg_kwargs)
        out, _, _ = tm.moe_ffn(*(torch.from_numpy(np.asarray(a)) for a in (x, router, wg, wu, wd)),
                               cfg)
        return out.numpy()


PKGS = [pytest.param(_Ref, id="ref"), pytest.param(_Port, id="port")]


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# -- the reference's cases (tests/test_moe.py), on both packages ---------------

@pytest.mark.parametrize("pkg", PKGS)
def test_combine_weights_sum_to_one_under_capacity(pkg):
    T, E = 16, 4
    probs = _softmax(np.random.RandomState(0).randn(T, E))
    combine, dispatch, _ = pkg.dispatch(probs, 2, T)
    np.testing.assert_allclose(combine.sum(axis=(1, 2)), 1.0, rtol=1e-5)
    assert float(dispatch.sum(axis=0).max()) <= 1.0


@pytest.mark.parametrize("pkg", PKGS)
def test_capacity_drops_overflow(pkg):
    probs = np.tile(np.array([[0.99, 0.01]], np.float32), (8, 1))
    combine, _, _ = pkg.dispatch(probs, 1, 3)
    kept = combine.sum(axis=(1, 2)) > 0
    assert kept.sum() == 3
    assert kept[:3].all(), "queue priority must be in token order"


@pytest.mark.parametrize("pkg", PKGS)
def test_aux_loss_favors_balance(pkg):
    T, E = 32, 4
    balanced = np.full((T, E), 1.0 / E, np.float32)
    skewed = _softmax(np.tile(np.array([[5.0, 0.0, 0.0, 0.0]], np.float32), (T, 1)))
    assert pkg.dispatch(skewed, 1, T)[2] > pkg.dispatch(balanced, 1, T)[2]


@pytest.mark.parametrize("pkg", PKGS)
def test_single_expert_equals_dense_ffn(pkg):
    """E=1, top_k=1, ample capacity: the MoE layer is the dense SwiGLU."""
    kw = dict(vocab_size=64, dim=16, n_layers=1, n_heads=2, n_kv_heads=2, ffn_hidden=32,
              num_experts=1, top_k=1, capacity_factor=2.0)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 16).astype(np.float32)
    router = np.zeros((16, 1), np.float32)
    wg, wu = rng.randn(1, 16, 32).astype(np.float32), rng.randn(1, 16, 32).astype(np.float32)
    wd = rng.randn(1, 32, 16).astype(np.float32)
    out = pkg.ffn(x, router, wg, wu, wd, kw)
    silu = lambda a: a / (1 + np.exp(-a))  # noqa: E731
    dense = (silu(x @ wg[0]) * (x @ wu[0])) @ wd[0]
    np.testing.assert_allclose(out, dense, rtol=2e-4, atol=2e-5)


# -- routing and the FFN against the reference ---------------------------------

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_k,capacity", [(2, 40), (2, 7), (1, 5)])
def test_route_is_the_reference(top_k, capacity, ties):
    """Experts, queue positions and what fits are equal; gates and the aux
    loss at f32 rounding. With ties (probabilities rounded to a coarse
    grid) the lower expert index wins, as ``lax.top_k`` picks it."""
    T, E = 64, 8
    probs = _softmax(np.random.RandomState(7).randn(T, E) * 2)
    if ties:
        probs = (np.round(probs * 8) / 8).astype(np.float32)
        probs[:, 3] = probs[:, 5]  # equal columns: every row a tie
    ref = jm._route(jnp.asarray(probs), top_k, capacity)
    got = tm._route(torch.from_numpy(probs), top_k, capacity)
    r_gates, r_idx, r_pos, r_within, r_aux = (np.asarray(a) for a in ref)
    gates, idx, pos, within, aux = got
    np.testing.assert_array_equal(idx.numpy(), r_idx)
    np.testing.assert_array_equal(pos.numpy(), r_pos)
    np.testing.assert_array_equal(within.numpy(), r_within)
    np.testing.assert_allclose(gates.numpy(), r_gates, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-6)
    if capacity < T * top_k // E:
        assert not within.all(), "the case must overflow"


def _models(dtype_name: str = "float32", capacity_factor: float = 1.25, remat=True):
    jcfg = dataclasses.replace(jm.MOE_CONFIGS["debug"], dtype=getattr(jnp, dtype_name),
                               capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tm.MOE_CONFIGS["debug"], dtype=getattr(torch, dtype_name),
                               capacity_factor=capacity_factor)
    params = jm.moe_init(jax.random.PRNGKey(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, params)
    model = tm.MoE(tcfg, device="cpu", attention="xla", remat=remat)
    model.load_state_dict(convert.moe_params_from_jax(host))
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    targets = rng.randint(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    return jcfg, params, model, tokens, targets


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["ample", "drops"])
def test_moe_ffn_matches_the_reference(capacity_factor):
    """One layer's sparse FFN on the same input: output and aux loss."""
    jcfg, params, model, _, _ = _models(capacity_factor=capacity_factor)
    x = np.random.RandomState(9).randn(2, 32, jcfg.dim).astype(np.float32)
    layer = params["layers"]
    ref_out, ref_aux = jm.moe_ffn(jnp.asarray(x), *(layer[k][0] for k in (
        "router", "w_gate", "w_up", "w_down")), jcfg)
    lt = model.layers[0]
    out, aux, dropped = tm.moe_ffn(torch.from_numpy(x), lt.router, lt.w_gate, lt.w_up, lt.w_down,
                                   model.cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(ref_aux), rtol=RTOL, atol=ATOL)
    if capacity_factor < 1:
        assert float(dropped) > 0, "the case must overflow"


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5], ids=["ample", "drops"])
def test_loss_logits_and_grads_match_f32(capacity_factor, remat):
    jcfg, params, model, tokens, targets = _models(capacity_factor=capacity_factor, remat=remat)
    t_tok, t_tgt = torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()
    ref_logits, ref_aux = jm.moe_forward(params, jnp.asarray(tokens), jcfg, remat=remat)
    with torch.no_grad():
        logits, aux = model(t_tok)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=RTOL, atol=ATOL)

    ref_loss, ref_grads = jax.value_and_grad(jm.moe_loss)(
        params, jnp.asarray(tokens), jnp.asarray(targets), jcfg, remat=remat)
    loss = model.loss(t_tok, t_tgt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=RTOL, atol=ATOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    host = jax.tree_util.tree_map(np.asarray, ref_grads)
    want = {k: v.numpy() for k, v in convert.moe_params_from_jax(host).items()}
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(grads["layers.0.router"]).max() > 0
    if capacity_factor < 1:
        assert float(model.last_dropped) > 0, "the case must overflow"


def test_loss_matches_bf16():
    jcfg, params, model, tokens, targets = _models("bfloat16")
    ref = float(jm.moe_loss(params, jnp.asarray(tokens), jnp.asarray(targets), jcfg))
    with torch.no_grad():
        loss = float(model.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()))
    np.testing.assert_allclose(loss, ref, rtol=2e-2)


def test_routing_at_bench_moe_width_is_the_reference():
    """bench_moe's widths (dim 1024, 8 experts of 2816, top 2) at its
    sequence (S 2048, batch 1: the capacity of 640 slots its training
    run has), depth cut to 4 layers, in f32 on the same converted weights and
    the trainer's first batch: each layer drops the same token-slots and
    gives the same aux loss in both packages. The reference's own layers
    are read by a callback on its ``_route`` inside its scan."""
    L, S = 4, 2048
    jcfg = dataclasses.replace(jm.MOE_CONFIGS["bench_moe"], n_layers=L, dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.MOE_CONFIGS["bench_moe"], n_layers=L, dtype=torch.float32)
    params = jm.moe_init(jax.random.PRNGKey(0), jcfg)
    model = tm.MoE(tcfg, device="cpu", attention="xla")
    model.load_state_dict(convert.moe_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    # the trainer's make_batch at step 0, replica 0
    toks = torch.randint(0, tcfg.vocab_size, (1, S + 1),
                         generator=torch.Generator().manual_seed(7919))[:, :-1]

    ref = []
    route = jm._route

    def recorded(probs, top_k, capacity):
        out = route(probs, top_k, capacity)
        jax.debug.callback(lambda w, a: ref.append((1 - float(np.mean(w)), float(a))),
                           out[3], out[4], ordered=True)
        return out

    jm._route = recorded
    try:
        _, ref_aux = jm.moe_forward(params, jnp.asarray(toks.numpy().astype(np.int32)), jcfg,
                                    remat="none")
        jax.effects_barrier()
    finally:
        jm._route = route
    got = []
    with torch.no_grad():
        h = model.embed_tokens(toks)
        for layer in model.layers:
            h, aux, dropped = layer(h)
            got.append((float(dropped), float(aux)))
    assert tcfg.capacity(S) == jcfg.capacity(S) == 640
    assert len(ref) == len(got) == L
    assert [d for d, _ in got] == [d for d, _ in ref]
    np.testing.assert_allclose([a for _, a in got], [a for _, a in ref], rtol=RTOL)
    np.testing.assert_allclose(float(np.mean([a for _, a in got])), float(ref_aux), rtol=RTOL)
    assert max(d for d, _ in ref) > 0, "the experts must overflow at this width"
    print("bench_moe width, per layer (dropped share, aux):", got)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_moe_params_from_jax_round_trips(dtype_name):
    """Each layer's slice of each stacked leaf, bits and dtype kept (the
    router in f32 whatever the model's dtype); stacked back, the tree."""
    jcfg = dataclasses.replace(jm.MOE_CONFIGS["debug"], dtype=getattr(jnp, dtype_name))
    host = jax.tree_util.tree_map(np.asarray, jm.moe_init(jax.random.PRNGKey(4), jcfg))
    sd = convert.moe_params_from_jax(host)
    model = tm.MoE(dataclasses.replace(tm.MOE_CONFIGS["debug"], dtype=getattr(torch, dtype_name)),
                   device="cpu")
    model.load_state_dict(sd)
    assert model.layers[0].router.dtype == torch.float32
    assert model.layers[1].w_gate.dtype == getattr(torch, dtype_name)

    def bits(t: torch.Tensor) -> np.ndarray:
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def host_bits(a: np.ndarray) -> np.ndarray:
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a

    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(bits(model.state_dict()[name]), host_bits(host[name]))
    for name, stacked in host["layers"].items():
        back = np.stack([bits(model.state_dict()[f"layers.{i}.{name}"])
                         for i in range(jcfg.n_layers)])
        np.testing.assert_array_equal(back, host_bits(stacked), err_msg=name)


def test_configs_are_the_reference():
    for name, ref in jm.MOE_CONFIGS.items():
        got = tm.MOE_CONFIGS[name]
        for f in dataclasses.fields(ref):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(ref, f.name), (name, f.name)
        assert got.capacity(2048) == ref.capacity(2048)
    cfg = tm.MOE_CONFIGS["bench_moe"]
    model = tm.MoE(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()


# -- the trainer --------------------------------------------------------------

def test_trainer_runs_the_moe_through_a_crash_and_an_http_heal():
    """``run_replicas(model="moe")``: two replica threads on the debug MoE,
    replica 1 crashing at the start of step 2 and healing over HTTP in
    place; every step logs the aux loss and the dropped share; the replicas
    end bitwise equal with their storage kept."""
    from torchft_tpu_torch import train
    from torchft_tpu_torch.train import Fault

    cfg = train.TrainConfig(model="moe", config="debug", steps=4, seq_len=16, quantize=False,
                            transport="http", faults=(Fault(1, 2, "crash"),))
    results = train.run_replicas(cfg, "cpu")
    assert [r["step"] for r in results] == [4, 4]
    assert results[1]["restarts"] == 1 and results[1]["metrics"]["heals"] >= 1
    assert all(r["storage_kept"] for r in results)
    entries = [e for r in results for e in r["log"]]
    assert all(np.isfinite(e["loss"]) and e["aux_loss"] > 0 and 0 <= e["dropped"] < 1
               for e in entries)
    for k, v in results[0]["params"].items():
        assert torch.equal(v, results[1]["params"][k]), k
    assert results[0]["params"]["layers.0.router"].dtype == torch.float32


def test_trainer_cli_takes_the_model_family():
    from torchft_tpu_torch import train

    with pytest.raises(SystemExit):
        train.main(["--model", "moe", "--config", "bench_1b", "--device", "cpu"])
