"""The port's serving building blocks against the JAX reference, on the
same seeded numpy inputs:

* K9's plain version (``swa_decode_plain``) against ``swa_decode_ref`` and
  the Pallas kernel in interpret mode: atol 3e-6 in f32, 2e-2 in bf16 (the
  bounds of ``tests/test_kernels.py``);
* MoE routing: dispatch bitwise, combine and the aux loss at 1e-6 (the
  two frameworks normalize the top-k probabilities in their own order);
  ``moe_block`` at 1e-5 in f32 and 2e-2 in bf16;
* the paged-cache ops bitwise;
* the allocator and ``ContinuousScheduler`` over a fake engine: the same
  completions and stats as the reference's scheduler on the same traces;
* greedy and top-k sampling fed the reference's Gumbel draws: bitwise;
* the replica's staleness bound.

``tests/test_torch_serve_engine.py`` holds the engine and the model paths.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.swa_attention.kernel import (  # noqa: E402
    swa_decode_attention as jax_swa_kernel)
from repro.kernels.swa_attention.ref import swa_decode_ref  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.serve import paged_cache as JPC  # noqa: E402
from repro.serve import sampling as JSAMP  # noqa: E402
from repro.serve import scheduler as JSCHED  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.swa_attention import ops as SWA  # noqa: E402
from repro_torch.kernels.swa_attention.ref import swa_decode_plain  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.params import params_from_jax  # noqa: E402
from repro_torch.serve import paged_cache as PC  # noqa: E402
from repro_torch.serve import sampling as SAMP  # noqa: E402
from repro_torch.serve import scheduler as SCHED  # noqa: E402
from repro_torch.serve.replica import ParamReplica  # noqa: E402

F32_TOL, BF16_TOL = 3e-6, 2e-2

# the reference functions, jitted: one compile per case instead of one per
# primitive keeps this file's CPU time down
jax_swa_ref = jax.jit(swa_decode_ref, static_argnames=("window",))
jax_route = jax.jit(JMOE.route, static_argnums=(1, 2))
jax_moe_block = jax.jit(JMOE.moe_block, static_argnums=(1,))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K9's plain version
# ---------------------------------------------------------------------------

def _swa_inputs(b, kv, g, d, t, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, d)).astype(np.float32)
    # row 0: keys from 0, query at the end; row 1: a window that slid
    # (base > 0, pos - base > window); row 2: most keys beyond pos; the
    # last row: no live key (its keys all lie beyond pos)
    base = np.array([0, 150, 3, 500][:b], np.int32)
    pos = np.array([t - 1, 150 + t - 1, 40, 100][:b], np.int32)
    return q, k, v, pos, base


SWA_CASES = [  # (B, KV, G, D, T, window)
    (4, 2, 2, 32, 256, 0),     # full attention, two 128-key blocks
    (4, 2, 2, 32, 256, 96),    # a sliding window
    (4, 2, 4, 16, 200, 64),    # T not a multiple of 128
    (3, 1, 1, 8, 77, 0),
]


@pytest.mark.parametrize("case", SWA_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_plain_matches_reference(case, dtype):
    b, kv, g, d, t, window = case
    q, k, v, pos, base = _swa_inputs(b, kv, g, d, t, seed=t + window)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    targs = [_t(np.asarray(a.astype(jnp.float32))).to(tdt) for a in jargs]
    want = np.asarray(jax_swa_ref(*jargs, pos, base, window=window)
                      .astype(jnp.float32))
    got = SWA.decode_attention(*targs, _t(pos), _t(base), window=window)
    assert got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    # the last row has no live key: the mean of its values, as the
    # reference's softmax over an all -1e30 row gives
    if b == 4:
        mean = targs[2][3].float().mean(0)                   # (KV, D)
        np.testing.assert_allclose(got[3].float().numpy(),
                                   mean[:, None].expand(kv, g, d).numpy(),
                                   rtol=0, atol=tol)
    if t % 128 == 0:
        pallas = jax_swa_kernel(*jargs, pos, base, window=window,
                                block_t=128, interpret=True)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(pallas.astype(jnp.float32)),
            rtol=0, atol=tol)


def test_swa_plain_scalar_position_broadcasts():
    q, k, v, _, _ = _swa_inputs(2, 2, 2, 16, 64, seed=3)
    want = np.asarray(jax_swa_ref(q, k, v, 40, window=16))
    got = swa_decode_plain(_t(q), _t(k), _t(v), 40, window=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _logits_with_ties(g, t, e, seed):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((g, t, e)).astype(np.float32)
    lg[0, 0] = 1.0                      # all experts tied
    lg[0, 1, :2] = 2.0                  # a tie for the top pick
    lg[-1, -1, 1:3] = 3.0               # a tie for the last token
    return lg


@pytest.mark.parametrize("g,t,e,k,cap", [
    (2, 16, 4, 2, 8),     # every token fits
    (2, 16, 4, 2, 4),     # capacity 4 drops tokens
    (1, 12, 8, 2, 4),
    (3, 8, 4, 1, 4),
])
def test_route_matches_reference(g, t, e, k, cap):
    lg = _logits_with_ties(g, t, e, seed=g * 100 + t + cap)
    jd, jc, ja = jax_route(jnp.asarray(lg), k, cap)
    d, c, a = MOE.route(_t(lg), k, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    assert abs(float(a) - float(ja)) <= 1e-6
    if cap == 4 and t == 16:
        assert float(d.sum()) < g * t * k      # some tokens were dropped


def test_capacity_matches_reference():
    for args in ((512, 2, 8, 1.25), (4, 2, 8, 1.25), (48, 2, 4, 1.25),
                 (7, 1, 3, 1.0)):
        assert MOE.capacity(*args) == JMOE.capacity(*args)


@pytest.mark.parametrize("dtype,shape", [("float32", (2, 8)),
                                         ("bfloat16", (2, 8)),
                                         ("bfloat16", (1, 5))])
def test_moe_block_matches_reference(dtype, shape):
    cfg, jcfg = get_config("mixtral-8x7b-smoke"), \
        jax_get_config("mixtral-8x7b-smoke")
    rng = np.random.default_rng(shape[1])
    jparams = {
        "router": 0.5 * rng.standard_normal((cfg.d_model, cfg.n_experts)),
        "w_gate": rng.standard_normal((cfg.n_experts, cfg.d_model,
                                       cfg.expert_d_ff)) / 12,
        "w_up": rng.standard_normal((cfg.n_experts, cfg.d_model,
                                     cfg.expert_d_ff)) / 12,
        "w_down": rng.standard_normal((cfg.n_experts, cfg.expert_d_ff,
                                       cfg.d_model)) / 16,
    }
    jparams = {k: v.astype(np.float32) for k, v in jparams.items()}
    x = rng.standard_normal((*shape, cfg.d_model)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    want, jaux = jax_moe_block(jparams, jcfg, jx)
    got, aux = MOE.moe_block(params_from_jax(jparams), cfg,
                             _t(np.asarray(jx.astype(jnp.float32))).to(
                                 getattr(torch, dtype)))
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert abs(float(aux) - float(jaux)) <= 1e-5


def test_moe_block_rejects_a_ragged_group():
    cfg = get_config("mixtral-8x7b-smoke")
    x = torch.zeros((1, 600, cfg.d_model))
    params = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    with pytest.raises(ValueError, match="routing group"):
        MOE.moe_block(params, cfg, x)


# ---------------------------------------------------------------------------
# paged-cache ops
# ---------------------------------------------------------------------------

PCFG = dict(page_size=4, num_pages=9, max_requests=3, max_pages_per_seq=5)


def test_paged_cache_ops_bitwise():
    rng = np.random.default_rng(0)
    jpc, pcfg = JPC.PagedCacheConfig(**PCFG), PC.PagedCacheConfig(**PCFG)
    pages = rng.standard_normal((10, 4, 2, 8)).astype(np.float32)
    table = np.array([[0, 1, 2, 3, 4], [5, 6, 9, 9, 9], [7, 8, 9, 9, 9]],
                     np.int32)
    pos = np.array([17, 6, 0], np.int32)
    new = rng.standard_normal((3, 2, 8)).astype(np.float32)
    page_idx = np.array([4, 6, 9], np.int32)
    offset = pos % 4
    want = JPC.write_token_kv(jnp.asarray(pages), jnp.asarray(new),
                              page_idx, offset)
    got = PC.write_token_kv(_t(pages.copy()), _t(new), _t(page_idx),
                            _t(offset))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        PC.gather_all(got, _t(table)).numpy(),
        np.asarray(JPC.gather_all(want, table)))
    for window in (4, 8, 12):
        jstart, jn = JPC.window_slots(jnp.asarray(pos), window, jpc, 5)
        start, n = PC.window_slots(_t(pos), window, pcfg, 5)
        assert n == jn
        np.testing.assert_array_equal(start.numpy(), np.asarray(jstart))
        jkeys, jbase = JPC.gather_window(want, table, jstart, jn)
        keys, base = PC.gather_window(got, _t(table), start, n)
        np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    k, v = PC.init_page_pool(2, 2, 8, pcfg)
    jk, _ = JPC.init_page_pool(2, 2, 8, jpc)
    assert tuple(k.shape) == jk.shape and k.dtype == torch.bfloat16
    assert not k.any() and not v.any()


def test_allocator_matches_reference():
    pcfg, jpc = PC.PagedCacheConfig(**PCFG), JPC.PagedCacheConfig(**PCFG)
    ours, ref = PC.PageAllocator(pcfg), JPC.PageAllocator(jpc)
    script = [("alloc", 0, 3), ("alloc", 1, 4), ("alloc", 2, 3),
              ("free", 0, 0), ("alloc", 2, 3), ("alloc", 3, 1),
              ("free", 1, 0), ("alloc", 4, 6), ("free", 2, 0)]
    for op, rid, n in script:
        got = ours.alloc(rid, n) if op == "alloc" else ours.free(rid)
        want = ref.alloc(rid, n) if op == "alloc" else ref.free(rid)
        assert got == want, (op, rid)
        assert ours.n_free == ref.n_free
        ours.check()
    for bad in (lambda a: a.free(0), lambda a: a.alloc(3, 1),
                lambda a: a.alloc(9, 0)):
        with pytest.raises(ValueError):
            bad(ours)
    assert pcfg.pages_needed(17) == jpc.pages_needed(17) == 5
    with pytest.raises(ValueError):
        pcfg.pages_needed(21)


# ---------------------------------------------------------------------------
# the scheduler over a fake engine
# ---------------------------------------------------------------------------

class FakeEngine:
    """The StepEngine verbs without a model: synthetic tokens, pages from a
    real allocator (the port's or the reference's)."""

    def __init__(self, pcfg, allocator):
        self.pcfg = pcfg
        self.alloc = allocator(pcfg)
        self.active = np.zeros(pcfg.max_requests, bool)
        self._slot_of: dict = {}
        self.steps = 0
        self.bad: dict = {}           # step -> rids reported non-finite

    def can_admit(self, prompt_len, max_new):
        total = prompt_len + max_new
        if total > self.pcfg.max_pages_per_seq * self.pcfg.page_size:
            raise ValueError("request exceeds per-request capacity")
        return (int(self.active.sum()) < self.pcfg.max_requests
                and self.alloc.can_alloc(self.pcfg.pages_needed(total)))

    def start(self, rid, prompt, max_new):
        pages = self.alloc.alloc(rid, self.pcfg.pages_needed(
            len(prompt) + max_new))
        assert pages is not None
        slot = int(np.flatnonzero(~self.active)[0])
        self.active[slot] = True
        self._slot_of[rid] = slot
        return np.asarray([9000 + rid + 100 * int(pages[0])], np.int32)

    def step(self):
        self.steps += 1
        return (np.arange(self.pcfg.max_requests, dtype=np.int32) * 1000
                + self.steps)

    def nonfinite_rids(self):
        return list(self.bad.get(self.steps, ()))

    def finish(self, rid):
        slot = self._slot_of.pop(rid)
        self.alloc.free(rid)
        self.active[slot] = False

    def slot_of(self, rid):
        return self._slot_of[rid]


TRACES = {
    "mixed": (dict(page_size=4, num_pages=6, max_requests=2,
                   max_pages_per_seq=3),
              [(4, 3, 0), (8, 4, 0), (2, 1, 1), (5, 6, 2), (1, 2, 9)], 64,
              {}),
    "backpressure": (dict(page_size=4, num_pages=4, max_requests=2,
                          max_pages_per_seq=2),
                     [(3, 4, 0)] * 6 + [(1, 1, 1)] * 3, 2, {}),
    "quarantine": (dict(page_size=4, num_pages=8, max_requests=3,
                        max_pages_per_seq=3),
                   [(4, 5, 0), (2, 6, 0), (6, 3, 1), (1, 4, 2)], 8,
                   {2: (1,), 4: (0,), 7: (1,), 9: (1,)}),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_scheduler_matches_reference(name):
    geom, reqs, queue_limit, bad = TRACES[name]
    out = {}
    for tag, pc, sched_mod in (
            ("ref", JPC, JSCHED), ("port", PC, SCHED)):
        engine = FakeEngine(pc.PagedCacheConfig(**geom), pc.PageAllocator)
        engine.bad = bad
        sched = sched_mod.ContinuousScheduler(
            engine, queue_limit=queue_limit, quarantine=bool(bad))
        trace = [sched_mod.Request(rid=i, prompt=np.zeros(p, np.int32),
                                   max_new=g, arrival=a)
                 for i, (p, g, a) in enumerate(reqs)]
        toks = sched.run(trace)
        engine.alloc.check()
        assert engine.alloc.n_free == geom["num_pages"]
        comps = {rid: (c.admitted, c.finished, c.failed,
                       None if c.tokens is None else c.tokens.tolist())
                 for rid, c in sched.completions.items()}
        out[tag] = ({k: v.tolist() for k, v in toks.items()}, comps,
                    sched.stats(), sched.clock, engine.steps)
    assert out["port"] == out["ref"]
    if name == "backpressure":
        assert out["port"][2]["rejected"] > 0
    if name == "quarantine":
        assert out["port"][2]["quarantined"] > 0


def test_scheduler_drain_is_one_fetch(monkeypatch):
    """The whole run, every decode step and drain, copies tokens to the
    host once."""
    calls = []
    real = torch.Tensor.cpu

    def counted(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)

    class TorchFake(FakeEngine):
        def start(self, rid, prompt, max_new):
            return torch.as_tensor(super().start(rid, prompt, max_new))

        def step(self):
            return torch.as_tensor(super().step())

    geom, reqs, _, _ = TRACES["mixed"]
    engine = TorchFake(PC.PagedCacheConfig(**geom), PC.PageAllocator)
    sched = SCHED.ContinuousScheduler(engine)
    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    toks = sched.run([SCHED.Request(rid=i, prompt=np.zeros(p, np.int32),
                                    max_new=g, arrival=a)
                      for i, (p, g, a) in enumerate(reqs)])
    assert len(calls) == 1 and len(toks) == len(reqs)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.7, 0), (0.7, 4),
                                               (2.0, 1), (1.3, 16)])
def test_sampling_matches_reference_draws(temperature, top_k):
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    logits = rng.standard_normal((5, 17)).astype(np.float32)
    logits[0, 3] = logits[0, 9] = logits[0].max() + 1.0    # a greedy tie
    jsc = JSAMP.SampleConfig(temperature=temperature, top_k=top_k)
    sc = SAMP.SampleConfig(temperature=temperature, top_k=top_k)
    for trial in range(4):
        key = jax.random.PRNGKey(100 + trial)
        want = np.asarray(JSAMP.sample_tokens(jnp.asarray(logits), jsc, key))
        gumbel = np.asarray(jax.random.gumbel(key, logits.shape,
                                              jnp.float32))
        got = SAMP.sample_tokens(_t(logits), sc, gumbel=_t(gumbel))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    if top_k:
        gen = torch.Generator().manual_seed(0)
        kth = np.sort(logits, axis=-1)[:, -top_k]   # ties at kth stay in
        for _ in range(8):
            got = SAMP.sample_tokens(_t(logits), sc, gen).numpy()
            assert all(logits[r, t] >= kth[r] for r, t in enumerate(got))


def test_sampled_decoding_needs_noise():
    with pytest.raises(ValueError):
        SAMP.sample_tokens(torch.zeros((1, 4)), SAMP.SampleConfig(1.0))


# ---------------------------------------------------------------------------
# the bounded-staleness replica
# ---------------------------------------------------------------------------

def _versioned(v):
    return {"w": torch.full((3,), float(v)),
            "n": {"b": torch.full((2,), float(v), dtype=torch.bfloat16)}}


@pytest.mark.parametrize("schedule", ["uniform", "straggler", "crash"])
def test_replica_staleness_bound(schedule):
    tau = 3
    rep = ParamReplica(_versioned(0), tau, schedule=schedule, seed=11)
    for v in range(1, 40):
        rep.publish(_versioned(v), v)
        if v % 2 == 0:
            rep.refresh()
        assert 0 <= rep.staleness <= tau
        served = rep.serving_params()
        assert float(served["w"][0]) == float(rep.serving_version)
        assert served["n"]["b"].dtype == torch.bfloat16
    bad = _versioned(40)
    bad["w"][1] = float("nan")
    assert rep.publish(bad) is None and rep.refused == 1
    with pytest.raises(ValueError):
        rep.publish(_versioned(45), 45)
    with pytest.raises(ValueError):
        ParamReplica(_versioned(0), -1)


def test_validate_paged_support():
    from repro_torch.serve import validate_paged_support
    assert validate_paged_support(get_config("qwen3-1.7b-smoke")) == 0
    assert validate_paged_support(get_config("mixtral-8x7b-smoke")) == 32
    gemma = dataclasses.replace(get_config("qwen3-1.7b-smoke"), n_layers=5,
                                sliding_window=16, global_every=2)
    with pytest.raises(NotImplementedError):
        validate_paged_support(gemma)
