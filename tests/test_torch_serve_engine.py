"""The port's paged serving engine against the JAX reference and against
the port's own dense loop.

* The step functions ``make_paged_prefill_step`` / ``make_paged_decode_step``
  against the reference's pure ones (never its racy ``StepEngine``), fed
  copies of the same inputs at every step (pools, tokens, positions, page
  table), for ``mixtral-8x7b-smoke`` and a windowed qwen3 smoke (window
  96, page 32).  Held: the advanced positions bitwise; the same pool rows
  (page, offset) written, and nothing else; the pools' values within 1e-2
  of the pool's largest magnitude and the logits within 0.15 (the bf16
  bound of ``tests/test_decode_consistency.py``).  The values cannot be
  bitwise: the two frameworks accumulate bf16 products in different
  orders, so even layer 0's keys round the other way in about one entry
  in 10^4, and later layers add the frameworks' different rounding of
  attention and MLP.  The page writes themselves are held bitwise in
  ``tests/test_torch_serve.py``.
* The port's paged engine against the port's dense loop, bitwise, for
  qwen3-1.7b-smoke with no window (the reference's own invariant).
* mixtral-8x7b-smoke, one request with a sliding window, against the
  reference's dense loop fed the port's tokens: each port token is within
  0.15 of the reference logits' maximum.
* bf16-held weights give bitwise the same logits and tokens as f32-held
  ones; the quarantine hooks; the launcher on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve.engine as JENG  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.serve.paged_cache import PagedCacheConfig as JaxPCfg  # noqa: E402

from repro_torch import tree as T  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist.train import (make_decode_step,  # noqa: E402
                                    make_prefill_step)
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       init_serving_params)
from repro_torch.serve import (ContinuousScheduler,  # noqa: E402
                               PagedCacheConfig, Request, StepEngine)
from repro_torch.serve import engine as ENG  # noqa: E402
from repro_torch.serve.paged_cache import init_page_pool  # noqa: E402

LOGIT_TOL = 0.15
POOL_REL = 1e-2


def _bf16_np(a):
    return np.asarray(a).astype(np.float32)


def _both_params(cfg, seed):
    """float32 parameters drawn once, as the port's tensors and as the
    numpy tree the reference's functions take."""
    params = init_params(TF.model_defs(cfg),
                         torch.Generator().manual_seed(seed))
    return params, T.tree_map(lambda t: t.numpy(), params)


def _arch(name, window):
    jcfg, cfg = jax_get_config(name), get_config(name)
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        cfg = dataclasses.replace(cfg, sliding_window=window)
    return jcfg, cfg


# (arch, window override, page size, table width, prompt lengths); the
# two prompts of a case pad to one bucket, so the reference compiles one
# prefill program per case
STEP_CASES = {
    "mixtral-8x7b-smoke": ("mixtral-8x7b-smoke", 0, 8, 8, (45, 42)),
    "qwen3-window96": ("qwen3-1.7b-smoke", 96, 32, 6, (150, 130)),
}


def _check_pools(kp, vp, jk, jv, what):
    for got, want in ((kp, jk), (vp, jv)):
        want = _bf16_np(want)
        got = got.float().numpy()
        # rows (layer, page, offset) holding a token: the same ones
        np.testing.assert_array_equal(np.any(got != 0, axis=(-2, -1)),
                                      np.any(want != 0, axis=(-2, -1)),
                                      err_msg=what)
        bound = POOL_REL * np.abs(want).max()
        assert np.abs(got - want).max() <= bound, what


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_paged_steps_match_reference(case, monkeypatch):
    name, window, ps, n_table, lens = STEP_CASES[case]
    jcfg, cfg = _arch(name, window)
    w = cfg.layer_window_sizes()[0]
    # the steps of both packages end in sample_tokens; returning the logits
    # there instead exposes them without touching either package's code
    monkeypatch.setattr(JENG, "sample_tokens", lambda logits, sc, key: logits)
    monkeypatch.setattr(ENG, "sample_tokens",
                        lambda logits, sc, gen=None: logits)
    flags = JTF.RunFlags(remat=False, kv_cache_dtype=jnp.bfloat16)
    params, jparams = _both_params(cfg, 1)
    r = len(lens)
    geom = dict(page_size=ps, num_pages=r * n_table, max_requests=r,
                max_pages_per_seq=n_table)
    jpcfg, pcfg = JaxPCfg(**geom), PagedCacheConfig(**geom)
    kp, vp = init_page_pool(cfg.n_layers, cfg.n_kv_heads,
                            cfg.resolved_head_dim, pcfg)
    jk = jnp.zeros(tuple(kp.shape), jnp.bfloat16)
    jv = jnp.zeros(tuple(kp.shape), jnp.bfloat16)
    rng = np.random.default_rng(7)
    table = np.full((r, n_table), pcfg.scratch_page, np.int32)
    key = jax.random.PRNGKey(0)
    for i, s in enumerate(lens):
        bucket_pages = -(-s // ps)
        table[i] = np.arange(i * n_table, (i + 1) * n_table)
        pages = table[i, :bucket_pages].copy()
        toks = np.zeros((1, bucket_pages * ps), np.int32)
        toks[0, :s] = rng.integers(0, cfg.vocab_size, s)
        jstep = jax.jit(JENG.make_paged_prefill_step(jcfg, jpcfg,
                                                     bucket_pages, flags))
        jlog, jk, jv = jstep(jparams, jk, jv, toks, np.int32(s), pages, key)
        step = ENG.make_paged_prefill_step(cfg, pcfg, bucket_pages)
        logits, kp, vp = step(params, kp, vp, torch.tensor(toks), s,
                              torch.tensor(pages))
        assert np.abs(logits.numpy() - np.asarray(jlog)).max() <= LOGIT_TOL
        _check_pools(kp, vp, jk, jv, f"prefill {i}")

    pos, active = np.array(lens, np.int32), np.ones((r,), bool)
    jdecode = jax.jit(JENG.make_paged_decode_step(jcfg, jpcfg, flags,
                                                  window=w))
    decode = ENG.make_paged_decode_step(cfg, pcfg, window=w)
    for t in range(4):
        tok = rng.integers(0, cfg.vocab_size, r).astype(np.int32)
        kp = torch.from_numpy(_bf16_np(jk)).to(torch.bfloat16)
        vp = torch.from_numpy(_bf16_np(jv)).to(torch.bfloat16)
        jlog, jpos, jk, jv = jdecode(jparams, jk, jv, tok, pos.copy(),
                                     table.copy(), active.copy(), key)
        logits, npos, kp, vp = decode(
            params, kp, vp, torch.tensor(tok), torch.tensor(pos),
            torch.tensor(table), torch.tensor(active))
        np.testing.assert_array_equal(npos.numpy(), np.asarray(jpos))
        assert np.abs(logits.numpy() - np.asarray(jlog)).max() <= LOGIT_TOL
        _check_pools(kp, vp, jk, jv, f"decode {t}")
        pos = np.asarray(jpos)
    if w:   # the window slid: row 0 reads from a page base above 0
        start, _ = ENG.PC.window_slots(torch.tensor(pos), w, pcfg, n_table)
        assert int(start[0]) > 0


def _dense_loop_tokens(cfg, params, prompt, n_new, max_len):
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    tok, cache = prefill(params, {"tokens": torch.tensor(prompt)[None]})
    out = [tok]
    for _ in range(n_new - 1):
        tok, cache = decode(params, cache, tok[:, None])
        out.append(tok)
    return torch.stack(out, dim=1)[0].numpy()


def test_decode_cache_pos_advances():
    """The dense cache of ``init_cache`` takes decode steps: the position
    advances and each step writes one cache row."""
    cfg = get_config("qwen3-1.7b-smoke")
    params = init_serving_params(TF.model_defs(cfg),
                                 torch.Generator().manual_seed(0))
    cache = TF.init_cache(cfg, 2, 8)
    assert cache["kv"][0].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                    cfg.resolved_head_dim)
    tok = torch.zeros((2, 1), dtype=torch.int32)
    for want in (1, 2):
        logits, cache = TF.decode_step(cfg, params, cache, tok)
        assert cache["pos"] == want and logits.shape == (2, 1,
                                                          cfg.vocab_size)
    written = cache["kv"][0].abs().sum(dim=(0, 1, 3, 4)) > 0
    assert written.tolist() == [True, True] + [False] * 6


@pytest.mark.parametrize("slots", [1, 2])
def test_paged_engine_matches_dense_loop_bitwise(slots):
    """qwen3-1.7b-smoke, full attention: three requests of mixed lengths,
    staggered admission over one or two slots; the gather width equals the
    dense ``max_len``, so each request's tokens are bitwise the dense B=1
    loop's."""
    cfg = get_config("qwen3-1.7b-smoke")
    params = init_serving_params(TF.model_defs(cfg),
                                 torch.Generator().manual_seed(4))
    ps, lens, gens, arrivals = 8, (8, 16, 8), (5, 3, 6), (0, 0, 1)
    n_table = max(-(-(p + g) // ps) for p, g in zip(lens, gens))
    pcfg = PagedCacheConfig(page_size=ps, num_pages=slots * n_table,
                            max_requests=slots, max_pages_per_seq=n_table)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=s, dtype=np.int32)
               for s in lens]
    engine = StepEngine(cfg, params, pcfg)
    toks = ContinuousScheduler(engine).run(
        [Request(rid=i, prompt=p, max_new=g, arrival=a)
         for i, (p, g, a) in enumerate(zip(prompts, gens, arrivals))])
    engine.alloc.check()
    assert engine.alloc.n_free == pcfg.num_pages
    for i, (p, g) in enumerate(zip(prompts, gens)):
        want = _dense_loop_tokens(cfg, params, p, g, n_table * ps)
        np.testing.assert_array_equal(toks[i], want, err_msg=f"rid {i}")


def test_mixtral_engine_matches_reference_dense_loop():
    """One mixtral-8x7b-smoke request (MoE routing couples batch rows, so
    one request only) whose window slides during the decode: every token
    of the port's paged engine is a near-argmax (within 0.15) of the
    reference dense loop's logits, fed the same tokens."""
    jcfg, cfg = _arch("mixtral-8x7b-smoke", 0)
    flags = JTF.RunFlags(remat=False, kv_cache_dtype=jnp.bfloat16)
    params, jparams = _both_params(cfg, 4)
    ps, s, gen = 8, 40, 8
    pcfg = PagedCacheConfig(page_size=ps, num_pages=6, max_requests=1,
                            max_pages_per_seq=6)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, size=s,
                                               dtype=np.int32)
    engine = StepEngine(cfg, params, pcfg)
    toks = ContinuousScheduler(engine).run(
        [Request(rid=0, prompt=prompt, max_new=gen)])[0]
    assert len(toks) == gen
    logits, cache = jax.jit(lambda p, t: JTF.prefill(
        jcfg, p, {"tokens": t}, s + gen, flags))(jparams, prompt[None])
    jdecode = jax.jit(lambda p, c, t: JTF.decode_step(jcfg, p, c, t, flags))
    for i, tok in enumerate(toks):
        row = np.asarray(logits)[0, -1]
        assert row[tok] >= row.max() - LOGIT_TOL, (i, tok, row.argmax())
        if i + 1 < len(toks):
            logits, cache = jdecode(jparams, cache,
                                    jnp.asarray([[tok]], jnp.int32))


def test_bf16_held_weights_are_bitwise_f32_held():
    """Every use of a matrix casts it to bf16 first, so the serving tree
    held in bf16 gives bitwise the tokens and logits of the same values
    held in float32."""
    cfg = get_config("mixtral-8x7b-smoke")
    defs = TF.model_defs(cfg)
    p16 = init_serving_params(defs, torch.Generator().manual_seed(3))
    p32 = T.tree_map(lambda a: a.float(), p16)
    assert p16["layers"]["ln_attn"].dtype == torch.float32
    assert p16["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    pcfg = PagedCacheConfig(page_size=8, num_pages=12, max_requests=2,
                            max_pages_per_seq=6)
    rng = np.random.default_rng(1)
    trace = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=s,
                                                dtype=np.int32), max_new=6)
             for i, s in enumerate((40, 16))]
    runs = []
    for params in (p32, p16):
        engine = StepEngine(cfg, params, pcfg)
        runs.append(ContinuousScheduler(engine).run(trace))
        step = ENG.make_paged_decode_step(cfg, pcfg, window=32)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ENG, "sample_tokens",
                       lambda logits, sc, gen=None: logits)
            runs.append(step(params, engine.k_pool, engine.v_pool,
                             torch.tensor([3, 5], dtype=torch.int32),
                             torch.tensor([7, 30], dtype=torch.int32),
                             torch.tensor(engine.table),
                             torch.tensor([True, True]))[0])
    for rid in (0, 1):
        np.testing.assert_array_equal(runs[0][rid], runs[2][rid])
    assert torch.equal(runs[1], runs[3])


def test_poisoned_request_is_quarantined_and_retried():
    """A NaN written into a live request's keys makes its next logits
    non-finite; the scheduler evicts it, requeues it once and it completes
    from scratch, while the other request runs on untouched."""
    cfg = get_config("qwen3-1.7b-smoke")
    params = init_serving_params(TF.model_defs(cfg),
                                 torch.Generator().manual_seed(0))
    pcfg = PagedCacheConfig(page_size=8, num_pages=8, max_requests=2,
                            max_pages_per_seq=4)
    rng = np.random.default_rng(2)
    trace = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=s,
                                                dtype=np.int32), max_new=6)
             for i, s in enumerate((8, 12))]
    clean = ContinuousScheduler(StepEngine(cfg, params, pcfg)).run(trace)
    engine = StepEngine(cfg, params, pcfg, check_finite=True)
    poisoned = []

    def on_tick(sched):
        if sched.clock == 2:
            engine.poison_kv(1)
            poisoned.append(engine.nonfinite_rids())

    sched = ContinuousScheduler(engine, quarantine=True, on_tick=on_tick)
    toks = sched.run(trace)
    assert poisoned == [[]]
    st = sched.stats()
    assert st["quarantined"] == 1 and st["failed"] == 0
    for rid in (0, 1):
        np.testing.assert_array_equal(toks[rid], clean[rid])
    assert sched.completions[1].admitted == 3
    engine.alloc.check()
    assert engine.alloc.n_free == pcfg.num_pages


def test_launcher_serves_on_the_cpu():
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", "mixtral-8x7b-smoke",
                      "--engine", "continuous", "--prompt-lens", "16,8,24",
                      "--gen", "4", "--batch", "2", "--page-size", "8"])
    assert [len(t) for t in out["tokens"]] == [4, 4, 4]
    assert out["engine"].alloc.n_free == out["engine"].pcfg.num_pages
    assert len(out["prefill_s"]) == 3
    loop = serve.main(["--device", "cpu", "--arch", "qwen3-1.7b-smoke",
                       "--engine", "loop", "--prompt-len", "8", "--gen", "3",
                       "--batch", "2", "--temperature", "0.8",
                       "--top-k", "5"])
    assert [len(t) for t in loop["tokens"]] == [3, 3]
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu", "--devices", "2"])
    # --fault-plan is ported: a plan with no events serves as without one
    planned = serve.main(["--device", "cpu", "--arch", "mixtral-8x7b-smoke",
                          "--engine", "continuous", "--prompt-lens",
                          "16,8,24", "--gen", "4", "--batch", "2",
                          "--page-size", "8", "--fault-plan",
                          '{"events": []}'])
    assert [list(t) for t in planned["tokens"]] == \
        [list(t) for t in out["tokens"]]
    assert planned["scheduler"].quarantined == 0


def test_launcher_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--engine", "continuous"])
