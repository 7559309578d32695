"""The port's LocalSGD / DiLoCo against the JAX package's, unit by unit.

Mirrors ``tests/test_local_sgd.py`` over mock managers (an identity
allreduce with scriptable commits and heals): each case with an outcome
runs the same script through both packages (numpy leaves into the
reference, torch tensors made from the same arrays into the port; optax's
``sgd`` against ``torch.optim.SGD``) and holds the port to the reference's
result at rtol 1e-6 / atol 1e-7, besides the reference test's own
expected values. Then what only the port has: in-place writes, state
registered as live tensors, SGD momentum created up front, and the
list-of-buckets API and ``partition_fragments`` against the reference's
over seeded leaf sets.
"""

from typing import Any, List

import numpy as np
import optax
import pytest
import torch
import torch.utils._pytree as pytree

from torchft_tpu import bucketing as ref_bucketing
from torchft_tpu import local_sgd as ref
from torchft_tpu.work import DummyWork as RefDummyWork
from torchft_tpu_torch import bucketing
from torchft_tpu_torch import local_sgd as port
from torchft_tpu_torch.work import DummyWork


@pytest.fixture(autouse=True)
def _no_knob_env(monkeypatch):
    monkeypatch.delenv("TORCHFT_SYNC_EVERY", raising=False)
    monkeypatch.delenv("TORCHFT_USE_BUCKETIZATION", raising=False)


class _MockManager:
    """Identity allreduce (a one-replica quorum) with scriptable commits
    and heals (``heal_at_quorum``: 1-based quorum indices)."""

    def __init__(self, commits: List[bool] = None, use_async_quorum: bool = False,
                 heal_at_quorum=()):
        self._use_async_quorum = use_async_quorum
        self.commits = commits if commits is not None else []
        self.heal_at_quorum = set(heal_at_quorum)
        self.commit_calls = 0
        self.quorum_calls = 0
        self.allreduce_log: List[Any] = []
        self._step = 0
        self.state_fns = {}

    def start_quorum(self, *a, **k):
        self.quorum_calls += 1

    def last_quorum_healed(self):
        return self.quorum_calls in self.heal_at_quorum

    def should_commit(self, *a, **k):
        ok = self.commits[self.commit_calls] if self.commit_calls < len(self.commits) else True
        self.commit_calls += 1
        if ok:
            self._step += 1
        return ok

    def current_step(self):
        return self._step

    def register_state_dict_fn(self, key, load_fn, value_fn):
        self.state_fns[key] = (load_fn, value_fn)


class RefMock(_MockManager):
    def allreduce(self, values, should_quantize=False, reduce_op=None):
        import jax

        self.allreduce_log.append(jax.tree_util.tree_map(lambda v: np.array(v, copy=True), values))
        return RefDummyWork(jax.tree_util.tree_map(np.asarray, values))


class PortMock(_MockManager):
    def allreduce(self, values, should_quantize=False, reduce_op=None):
        self.allreduce_log.append(pytree.tree_map(lambda t: t.detach().clone(), values))
        return DummyWork(pytree.tree_map(lambda t: t.detach().clone(), values))


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.is_port = name == "port"
        self.mod = port if self.is_port else ref
        self.Mock = PortMock if self.is_port else RefMock

    def tree(self, d):
        """A dict of arrays as this package's leaves."""
        if self.is_port:
            return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in d.items()}
        return {k: np.array(v, copy=True) for k, v in d.items()}

    def diloco(self, m, params, lr, momentum=None, nesterov=False, **kw):
        if self.is_port:
            outer = lambda ps: torch.optim.SGD(  # noqa: E731
                ps, lr=lr, momentum=momentum or 0.0, nesterov=nesterov)
        else:
            outer = optax.sgd(lr, momentum=momentum, nesterov=nesterov)
        return self.mod.DiLoCo(m, params, outer, **kw)


REF, PORT = _Pkg("ref"), _Pkg("port")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x)


def _assert_close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close(x, y)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def both(script):
    """``script(pkg)`` through both packages; the port's result (as numpy)
    held to the reference's. Returns the port's."""
    want = _np(script(REF))
    got = _np(script(PORT))
    _assert_close(got, want)
    return got


def drift(params, by=0.1):
    return {k: v - by for k, v in params.items()}


# -- LocalSGD -------------------------------------------------------------------

def test_localsgd_sync_cadence():
    def script(pkg):
        m = pkg.Mock()
        params = pkg.tree({"w": np.array([1.0])})
        ls = pkg.mod.LocalSGD(m, params, sync_every=3)
        for _ in range(6):
            params = ls.step(params)
        return [m.quorum_calls, m.commit_calls]

    assert both(script) == [2, 2]


@pytest.mark.parametrize("commit,want", [(False, 5.0), (True, 3.0)],
                         ids=["failed_commit_restores_backup", "commit_adopts_average"])
def test_localsgd_commit_outcome(commit, want):
    def script(pkg):
        m = pkg.Mock(commits=[commit])
        ls = pkg.mod.LocalSGD(m, pkg.tree({"w": np.array([5.0])}), sync_every=1)
        return ls.step(pkg.tree({"w": np.array([3.0])}))["w"]

    np.testing.assert_allclose(both(script), [want])


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_localsgd_registers_state_dict_fn(pkg):
    m = pkg.Mock()
    pkg.mod.LocalSGD(m, pkg.tree({"w": np.zeros(1)}), sync_every=2)
    assert "LocalSGD" in m.state_fns


def test_localsgd_env_sync_every_beats_the_argument(monkeypatch):
    monkeypatch.setenv("TORCHFT_SYNC_EVERY", "2")

    def script(pkg):
        m = pkg.Mock()
        params = pkg.tree({"w": np.array([1.0])})
        ls = pkg.mod.LocalSGD(m, params, sync_every=5)
        for _ in range(4):
            params = ls.step(params)
        return [ls.sync_every, m.quorum_calls]

    assert both(script) == [2, 2]


# -- DiLoCo validation --------------------------------------------------------------

@pytest.mark.parametrize("kwargs,params,async_quorum,match", [
    (dict(sync_every=2), {"w": np.zeros(2)}, True, "synchronous quorum"),
    (dict(sync_every=3, num_fragments=2),
     {"a": np.zeros(2), "b": np.zeros(2), "c": np.zeros(2)}, False, "divisible"),
    (dict(sync_every=2, num_fragments=2, fragment_sync_delay=1),
     {"a": np.zeros(2), "b": np.zeros(2)}, False, "sync before"),
    (dict(sync_every=2, fragment_update_alpha=1.5), {"w": np.zeros(2)}, False, "alpha"),
    (dict(sync_every=1, fragment_partition=[[0], [1]]),
     {"a": np.zeros(2), "b": np.zeros(2)}, False, "only 1 fragment"),
], ids=["requires_sync_quorum", "sync_every_divisible", "delay_bound", "alpha_range",
        "fewer_steps_than_fragments"])
@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_diloco_validation(pkg, kwargs, params, async_quorum, match):
    m = pkg.Mock(use_async_quorum=async_quorum)
    with pytest.raises(ValueError, match=match):
        pkg.diloco(m, pkg.tree(params), 1.0, **kwargs)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_diloco_env_sync_every_is_validated_and_used(pkg, monkeypatch):
    params = {"a": np.zeros(2), "b": np.zeros(2)}
    monkeypatch.setenv("TORCHFT_SYNC_EVERY", "3")
    with pytest.raises(ValueError, match="divisible"):
        pkg.diloco(pkg.Mock(), pkg.tree(params), 1.0, sync_every=4, num_fragments=2)
    monkeypatch.setenv("TORCHFT_SYNC_EVERY", "8")
    d = pkg.diloco(pkg.Mock(), pkg.tree(params), 1.0, sync_every=4, num_fragments=2)
    assert d.sync_every == 4


@pytest.mark.parametrize("env,explicit,want", [
    ("1", False, True), (None, False, False), (None, True, True), ("false", True, True),
    ("off", False, False), ("", False, False),
], ids=["env_forces_on", "absent_false", "absent_true", "false_never_forces_off",
        "off_stays_off", "empty_is_default"])
@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_bucketization_precedence(pkg, monkeypatch, env, explicit, want):
    if env is None:
        monkeypatch.delenv("TORCHFT_USE_BUCKETIZATION", raising=False)
    else:
        monkeypatch.setenv("TORCHFT_USE_BUCKETIZATION", env)
    d = pkg.diloco(pkg.Mock(), pkg.tree({"w": np.zeros(4, np.float32)}), 1.0, sync_every=2,
                   use_bucketization=explicit)
    assert all(f._use_bucketization == want for f in d.fragments)


# -- DiLoCo math -----------------------------------------------------------------------

W1 = {"w": np.array([1.0], dtype=np.float32)}


def _cycles(pkg, m, diloco_kwargs, steps, lr=1.0, momentum=None, nesterov=False, init=W1,
            by=0.1):
    params = pkg.tree(init)
    d = pkg.diloco(m, params, lr, momentum=momentum, nesterov=nesterov, **diloco_kwargs)
    history = []
    for _ in range(steps):
        params = d.step(drift(params, by))
        history.append(_np(params))
    return d, params, history


@pytest.mark.parametrize("kwargs,lr,want", [
    (dict(sync_every=2), 1.0, 0.8),
    (dict(sync_every=2), 0.5, 0.9),
    (dict(sync_every=2, fragment_update_alpha=0.5), 0.5, 0.85),
    (dict(sync_every=3, fragment_sync_delay=1), 1.0, 0.8),
], ids=["single_fragment_outer_sgd", "outer_lr_scales_update", "alpha_merges_local",
        "delay_overlap"])
def test_diloco_outer_step(kwargs, lr, want):
    steps = kwargs["sync_every"]

    def script(pkg):
        d, params, _h = _cycles(pkg, pkg.Mock(), kwargs, steps, lr=lr)
        return [params["w"], d.fragments[0].original[0]]

    out = both(script)
    np.testing.assert_allclose(out[0], [want], rtol=1e-6)


def test_diloco_failed_commit_restores_global():
    def script(pkg):
        _d, params, _h = _cycles(pkg, pkg.Mock(commits=[False]), dict(sync_every=2), 2)
        return params["w"]

    np.testing.assert_allclose(both(script), [1.0], rtol=1e-6)


def test_diloco_outer_momentum_accumulates():
    def script(pkg):
        _d, _p, history = _cycles(pkg, pkg.Mock(), dict(sync_every=1), 2, momentum=0.9)
        return [h["w"] for h in history]

    out = both(script)
    np.testing.assert_allclose(out[0], [0.9], rtol=1e-6)
    # second pseudograd 0.1; momentum 0.9 * 0.1 + 0.1 = 0.19; 0.9 - 0.19
    np.testing.assert_allclose(out[1], [0.71], rtol=1e-5)


def test_diloco_nesterov_matches_optax_over_cycles():
    """torch's Nesterov SGD is optax.sgd(nesterov=True)'s recurrence, with
    the momentum created zero up front: six cycles of varied drift."""
    init = {"w": np.linspace(-1.0, 1.0, 7).astype(np.float32)}

    def script(pkg):
        d, _p, history = _cycles(pkg, pkg.Mock(), dict(sync_every=2), 12, lr=0.7, momentum=0.9,
                                 nesterov=True, init=init, by=0.05)
        return [h["w"] for h in history] + [d.fragments[0].original[0]]

    both(script)


def test_diloco_two_fragments_staggered():
    def script(pkg):
        m = pkg.Mock()
        d, params, _h = _cycles(pkg, m, dict(sync_every=4, fragment_partition=[[0], [1]]), 4,
                                init={"a": np.array([1.0], np.float32),
                                      "b": np.array([2.0], np.float32)})
        assert m.commit_calls == 2
        return [params["a"], params["b"], d.fragments[0].original[0], d.fragments[1].original[0]]

    a, b, ga, gb = both(script)
    np.testing.assert_allclose(b, [1.6], rtol=1e-6)
    np.testing.assert_allclose(a, [0.6], rtol=1e-6)
    np.testing.assert_allclose(ga, [0.8], rtol=1e-6)
    np.testing.assert_allclose(gb, [1.6], rtol=1e-6)


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_diloco_registers_per_fragment_state(pkg):
    m = pkg.Mock()
    pkg.diloco(m, pkg.tree({"a": np.zeros(2), "b": np.zeros(3)}), 1.0, sync_every=2,
               num_fragments=2)
    assert "StreamingDiLoCoFragment_0" in m.state_fns
    assert "StreamingDiLoCoFragment_1" in m.state_fns
    state = m.state_fns["StreamingDiLoCoFragment_0"][1]()
    assert "original_parameters" in state and "outer_optimizer" in state


# -- heals --------------------------------------------------------------------------------

def test_diloco_pseudograd_uses_healed_params():
    def script(pkg):
        m = pkg.Mock(heal_at_quorum={1})
        healed = pkg.tree({"w": np.array([10.0], np.float32)})
        d = pkg.diloco(m, pkg.tree(W1), 1.0, sync_every=2, get_params=lambda: healed)
        params = pkg.tree({"w": np.array([0.8], np.float32)})  # stale locals
        for _ in range(2):
            params = d.step(params)
        return [m.allreduce_log[0][0], params["w"]]

    sent, out = both(script)
    np.testing.assert_allclose(sent, [-9.0], rtol=1e-6)
    np.testing.assert_allclose(out, [10.0], rtol=1e-6)


def test_diloco_no_heal_keeps_caller_params():
    def script(pkg):
        m = pkg.Mock()
        sentinel = pkg.tree({"w": np.array([99.0], np.float32)})
        d = pkg.diloco(m, pkg.tree(W1), 1.0, sync_every=2, get_params=lambda: sentinel)
        params = pkg.tree({"w": np.array([0.8], np.float32)})
        for _ in range(2):
            params = d.step(params)
        return m.allreduce_log[0][0]

    np.testing.assert_allclose(both(script), [0.2], rtol=1e-6)


def test_diloco_heal_without_get_params_contributes_zero_pseudograd():
    def script(pkg):
        m = pkg.Mock(heal_at_quorum={1})
        d = pkg.diloco(m, pkg.tree(W1), 1.0, sync_every=2)
        params = pkg.tree({"w": np.array([-50.0], np.float32)})
        for _ in range(2):
            params = d.step(params)
        return [m.allreduce_log[0][0], params["w"]]

    sent, out = both(script)
    np.testing.assert_allclose(sent, [0.0])
    np.testing.assert_allclose(out, [1.0], rtol=1e-6)


def test_diloco_heal_fallback_survives_delay_boundary():
    def script(pkg):
        m = pkg.Mock(heal_at_quorum={1})
        d = pkg.diloco(m, pkg.tree({"a": np.array([1.0], np.float32),
                                    "b": np.array([2.0], np.float32)}), 1.0, sync_every=4,
                       fragment_partition=[[0], [1]], fragment_sync_delay=1)
        params = pkg.tree({"a": np.array([-50.0], np.float32), "b": np.array([-60.0], np.float32)})
        return d.step(params)

    out = both(script)
    np.testing.assert_allclose(out["a"], [1.0])
    np.testing.assert_allclose(out["b"], [2.0])


def test_localsgd_heal_without_get_params_averages_backup():
    def script(pkg):
        m = pkg.Mock(heal_at_quorum={1})
        ls = pkg.mod.LocalSGD(m, pkg.tree({"w": np.array([4.0], np.float32)}), sync_every=1)
        load_fn, _ = m.state_fns["LocalSGD"]
        load_fn({"backup": pkg.tree({"w": np.array([7.0], np.float32)})})
        out = ls.step(pkg.tree({"w": np.array([-99.0], np.float32)}))
        return [m.allreduce_log[0]["w"], out["w"]]

    sent, out = both(script)
    np.testing.assert_allclose(sent, [7.0])
    np.testing.assert_allclose(out, [7.0])


def test_localsgd_allreduces_healed_params():
    def script(pkg):
        m = pkg.Mock(heal_at_quorum={1})
        healed = pkg.tree({"w": np.array([7.0], np.float32)})
        ls = pkg.mod.LocalSGD(m, pkg.tree({"w": np.array([1.0], np.float32)}), sync_every=1,
                              get_params=lambda: healed)
        return ls.step(pkg.tree({"w": np.array([0.5], np.float32)}))["w"]

    np.testing.assert_allclose(both(script), [7.0])


# -- flush --------------------------------------------------------------------------------

def test_flush_completes_inflight_sync():
    def script(pkg):
        m = pkg.Mock()
        d = pkg.diloco(m, pkg.tree(W1), 1.0, sync_every=3, fragment_sync_delay=1)
        params = pkg.tree(W1)
        for _ in range(2):  # stops right after the prepare boundary
            params = d.step(drift(params))
        assert d.fragments[0]._work is not None
        params = d.flush(params)
        assert d.fragments[0]._work is None and m.commit_calls == 1
        return params["w"]

    np.testing.assert_allclose(both(script), [0.8], rtol=1e-6)


def test_flush_noop_when_idle():
    def script(pkg):
        m = pkg.Mock()
        d = pkg.diloco(m, pkg.tree(W1), 1.0, sync_every=2)
        out = d.flush(pkg.tree(W1))
        assert m.commit_calls == 0
        return out["w"]

    np.testing.assert_allclose(both(script), [1.0])


# -- fragments and buckets against the reference ---------------------------------------

def _leaf_set(seed, n=9):
    rng = np.random.RandomState(seed)
    dtypes = [np.float32, np.float64, np.float16, np.int32]
    return [rng.randn(*rng.randint(1, 40, size=rng.randint(1, 3))).astype(dtypes[rng.randint(4)])
            for _ in range(n)]


@pytest.mark.parametrize("num_fragments", [1, 2, 3, 5, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_fragments_matches_the_reference(seed, num_fragments):
    leaves = _leaf_set(seed)
    got = port.partition_fragments([torch.from_numpy(a) for a in leaves], num_fragments)
    assert got == ref.partition_fragments(leaves, num_fragments)
    assert sorted(i for f in got for i in f) == list(range(len(leaves)))


def test_partition_fragments_balanced():
    leaves = [torch.zeros(100, dtype=torch.float64), torch.zeros(1, dtype=torch.float64),
              torch.zeros(50, dtype=torch.float64), torch.zeros(49, dtype=torch.float64)]
    frags = port.partition_fragments(leaves, 2)
    sizes = [sum(leaves[i].numel() * 8 for i in f) for f in frags]
    assert abs(sizes[0] - sizes[1]) <= 100 * 8
    assert len(port.partition_fragments([torch.zeros(2)], 4)) == 1


@pytest.mark.parametrize("cap", [1 << 30, 256, 50])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_pack_and_unpack_match_the_reference_buckets(seed, cap):
    """DiLoCo's unquantized pre-bucketing: the port's plan and packed flats
    equal the reference's ``make_buckets``, and ``unpack`` inverts them."""
    leaves = _leaf_set(seed)
    want = ref_bucketing.make_buckets(leaves, cap)
    tleaves = [torch.from_numpy(a) for a in leaves]
    plan = bucketing.build_plan(tleaves, cap)
    flats, _pooled = bucketing.pack(tleaves, plan)
    assert plan.metas == [m for _f, m in want]
    for gf, (wf, _) in zip(flats, want):
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    out = bucketing.unpack(flats, plan)
    for a, b in zip(leaves, out):
        np.testing.assert_array_equal(b.numpy(), a)
        assert b.numpy().dtype == a.dtype


@pytest.mark.parametrize("cap,n_buckets", [(100 * 4 * 2, 2), (50, 2), (1 << 30, 1)],
                         ids=["cap_splits", "oversize_leaf_own_bucket", "one_bucket"])
def test_bucket_counts(cap, n_buckets):
    leaves = [torch.ones(100)] * (4 if n_buckets == 2 and cap > 50 else 2)
    assert len(bucketing.build_plan(leaves, cap)) == n_buckets


# -- what only the port has -------------------------------------------------------------

def test_step_writes_in_place_and_returns_the_same_tree():
    m = PortMock()
    params = {"w": torch.ones(4), "b": torch.zeros(2)}
    ptrs = {k: v.data_ptr() for k, v in params.items()}
    d = port.DiLoCo(m, params, lambda ps: torch.optim.SGD(ps, lr=0.5), sync_every=2)
    for _ in range(2):
        with torch.no_grad():
            for v in params.values():
                v.sub_(0.1)
        assert d.step(params) is params
    assert {k: v.data_ptr() for k, v in params.items()} == ptrs
    torch.testing.assert_close(params["w"], torch.full((4,), 0.9))
    # the pseudogradient was a tensor of its own, not a view of a leaf
    assert all(t.data_ptr() not in ptrs.values() for t in m.allreduce_log[0])


def test_nn_module_parameters_stay_the_module_s():
    model = torch.nn.Linear(3, 2)
    params = dict(model.named_parameters())
    d = port.DiLoCo(PortMock(), params, lambda ps: torch.optim.SGD(ps, lr=1.0), sync_every=1)
    inner = torch.optim.SGD(model.parameters(), lr=0.1)
    model(torch.ones(1, 3)).sum().backward()
    inner.step()
    d.step(params)
    assert all(p is params[n] for n, p in model.named_parameters())
    # outer lr 1 adopts the local parameters: the global copy follows
    for g, p in zip(d.fragments[0].original, (params[k] for k in sorted(params))):
        torch.testing.assert_close(g, p.detach())


def test_momentum_exists_up_front_and_keeps_its_tree():
    m = PortMock()
    d = port.DiLoCo(m, {"w": torch.ones(3)},
                    lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9, nesterov=True),
                    sync_every=1)
    opt = d.fragments[0].outer_optimizer
    before = pytree.tree_structure(opt.state_dict())
    buf = opt.state[d.fragments[0].original[0]]["momentum_buffer"]
    assert not buf.any()
    d.step({"w": torch.full((3,), 0.9)})
    assert pytree.tree_structure(opt.state_dict()) == before
    assert opt.state[d.fragments[0].original[0]]["momentum_buffer"] is buf
    torch.testing.assert_close(buf, torch.full((3,), 0.1))


def test_fragment_state_is_live_and_loads_in_place():
    m = PortMock()
    d = port.DiLoCo(m, {"w": torch.ones(3)},
                    lambda ps: torch.optim.SGD(ps, lr=0.7, momentum=0.9), sync_every=2)
    load_fn, save_fn = m.state_fns["StreamingDiLoCoFragment_0"]
    frag = d.fragments[0]
    saved = save_fn()
    assert saved["original_parameters"][0] is frag.original[0]
    buf = frag.outer_optimizer.state[frag.original[0]]["momentum_buffer"]
    assert saved["outer_optimizer"]["state"][0]["momentum_buffer"] is buf
    ptrs = (frag.original[0].data_ptr(), buf.data_ptr())
    # a heal hands other tensors (HTTP: fresh CPU tensors), or arrays
    load_fn({"original_parameters": [np.full(3, 5.0, np.float32)],
             "outer_optimizer": {"state": {0: {"momentum_buffer": torch.full((3,), 2.0)}},
                                 "param_groups": [dict(saved["outer_optimizer"]["param_groups"][0],
                                                       lr=0.25)]}})
    assert (frag.original[0].data_ptr(), buf.data_ptr()) == ptrs
    torch.testing.assert_close(frag.original[0], torch.full((3,), 5.0))
    torch.testing.assert_close(buf, torch.full((3,), 2.0))
    assert frag.outer_optimizer.param_groups[0]["lr"] == 0.25
    # the live tensors themselves (a PG heal lands in them): nothing moves
    load_fn(save_fn())
    torch.testing.assert_close(frag.original[0], torch.full((3,), 5.0))


def test_localsgd_state_is_live_and_loads_in_place():
    m = PortMock()
    ls = port.LocalSGD(m, {"w": torch.ones(2), "b": torch.zeros(1)}, sync_every=2)
    load_fn, save_fn = m.state_fns["LocalSGD"]
    live = save_fn()["backup"]
    ptrs = [t.data_ptr() for t in live]
    load_fn({"backup": {"w": torch.full((2,), 3.0), "b": torch.full((1,), 4.0)}})
    assert [t.data_ptr() for t in save_fn()["backup"]] == ptrs
    # leaves in the sorted-key order: b, then w
    torch.testing.assert_close(live[0], torch.full((1,), 4.0))
    torch.testing.assert_close(live[1], torch.full((2,), 3.0))
    assert ls.sync_every == 2


def test_non_tensor_leaves_are_refused():
    with pytest.raises(TypeError, match="tensors"):
        port.DiLoCo(PortMock(), {"w": np.zeros(2)}, lambda ps: torch.optim.SGD(ps, lr=1.0),
                    sync_every=1)


def test_set_sync_every_is_validated_and_waits_for_the_cycle_boundary():
    m = PortMock()
    params = {"a": torch.zeros(2), "b": torch.zeros(2)}
    d = port.DiLoCo(m, params, lambda ps: torch.optim.SGD(ps, lr=1.0), sync_every=4,
                    num_fragments=2, fragment_sync_delay=1)
    with pytest.raises(ValueError, match="multiple"):
        d.set_sync_every(3)
    with pytest.raises(ValueError, match="sync before"):
        d.set_sync_every(2)
    d.step(params)  # mid-cycle: the prepare of fragment 0
    d.set_sync_every(8)
    assert d.sync_every == 2
    d.step(params)  # the perform closes the cycle
    d.step(params)
    assert d.sync_every == 4


def test_policy_adjuster_is_registered_when_the_manager_has_one():
    class WithPolicy(PortMock):
        def __init__(self):
            super().__init__()
            self.adjusters = {}

        def register_policy_adjuster(self, knob, fn):
            self.adjusters[knob] = fn

    m = WithPolicy()
    d = port.DiLoCo(m, {"w": torch.zeros(2)}, lambda ps: torch.optim.SGD(ps, lr=1.0),
                    sync_every=4)
    m.adjusters["TORCHFT_SYNC_EVERY"]("2")
    d.step({"w": torch.zeros(2)})  # local step 0 -> the queued cadence applies
    assert d.sync_every == 2
    ls = port.LocalSGD(m, {"w": torch.zeros(2)}, sync_every=3)
    m.adjusters["TORCHFT_SYNC_EVERY"]("5")
    assert ls.sync_every == 5
    m.adjusters["TORCHFT_SYNC_EVERY"](None)
    assert ls.sync_every == 3


def test_package_exports():
    import torchft_tpu_torch

    assert torchft_tpu_torch.DiLoCo is port.DiLoCo
    assert torchft_tpu_torch.LocalSGD is port.LocalSGD


@pytest.mark.parametrize("raw", [None, "", " ", "0", "false", "No", "OFF", "1", "yes", "on", "x"])
def test_env_bool_matches_the_reference(monkeypatch, raw):
    from torchft_tpu import knobs as ref_knobs
    from torchft_tpu_torch import knobs

    if raw is None:
        monkeypatch.delenv("TORCHFT_USE_BUCKETIZATION", raising=False)
    else:
        monkeypatch.setenv("TORCHFT_USE_BUCKETIZATION", raw)
    for default in (False, True):
        assert knobs.env_bool("TORCHFT_USE_BUCKETIZATION", default) == \
            ref_knobs.env_bool("TORCHFT_USE_BUCKETIZATION", default)


@pytest.mark.parametrize("raw", [None, "", "0", "7", "-3"])
def test_env_int_matches_the_reference(monkeypatch, raw):
    from torchft_tpu import knobs as ref_knobs
    from torchft_tpu_torch import knobs

    if raw is None:
        monkeypatch.delenv("TORCHFT_SYNC_EVERY", raising=False)
    else:
        monkeypatch.setenv("TORCHFT_SYNC_EVERY", raw)
    assert knobs.env_int("TORCHFT_SYNC_EVERY", 5) == ref_knobs.env_int("TORCHFT_SYNC_EVERY", 5)


def test_fake_process_group_wrapper_fails_the_chosen_ops_and_delegates():
    from torchft_tpu_torch.process_group import (
        FakeProcessGroupWrapper, ProcessGroupDummy, ReduceOp,
    )

    pg = FakeProcessGroupWrapper(ProcessGroupDummy())
    assert pg.size() == 1 and pg.rank() == 0 and pg.errored() is None
    pg.report_future_error(RuntimeError("boom"), skip_ops=1, times=2)
    outcomes = []
    for _ in range(4):
        fut = pg.allreduce([torch.ones(2)], ReduceOp.SUM).get_future()
        outcomes.append(fut.exception() is None)
    assert outcomes == [True, False, False, True]
    pg.report_configure_error(ValueError("no rendezvous"))
    with pytest.raises(ValueError, match="rendezvous"):
        pg.configure("127.0.0.1:1/x", 0, 1)
    pg.configure("127.0.0.1:1/x", 0, 1)  # once only
    pg.set_timeout(5.0)
    pg.shutdown()


def test_heal_into_an_optimizer_with_lazy_state_loads_it():
    """An outer optimizer whose state torch creates at the first step
    (Adam): a heal before that step hands state the live tree lacks, and it
    is loaded."""
    m = PortMock()
    d = port.DiLoCo(m, {"w": torch.ones(3)}, lambda ps: torch.optim.Adam(ps, lr=0.1),
                    sync_every=1)
    other = torch.optim.Adam([torch.zeros(3, requires_grad=True)], lr=0.1)
    other.param_groups[0]["params"][0].grad = torch.ones(3)
    other.step()
    load_fn, _save = m.state_fns["StreamingDiLoCoFragment_0"]
    load_fn({"original_parameters": [torch.full((3,), 2.0)],
             "outer_optimizer": other.state_dict()})
    state = d.fragments[0].outer_optimizer.state[d.fragments[0].original[0]]
    torch.testing.assert_close(state["exp_avg"], torch.full((3,), 0.1))
    assert len(d.state_tensors()) == 4  # the global, step, exp_avg, exp_avg_sq
