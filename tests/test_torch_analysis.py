"""The port's analysis passes (`repro_torch.analysis`: the AST lint, the
entry-point registry, the step audit and the CLI) against the JAX
reference's, on the CPU.

What is held, and how:

* Lint parity, exactly: on every ``.py`` file under ``src/repro/`` the
  port's ``hot_functions`` gives the reference's qualnames, and the port's
  ``host-sync-in-step`` and ``np-on-traced`` findings contain the
  reference's (same ``where``, rule and line; the port adds ``.cpu()``,
  ``.numpy()`` and ``torch.cuda.synchronize``).  The reference tests'
  planted snippets rule by rule, and planted ``generator-reuse`` and
  ``tile-misalign`` cases.  The port's own tree is clean against its
  baseline.
* The audit's wire, exactly against ``tests/golden/collective_inventory.
  json`` by strategy and kind, with two stated differences: the
  reference's async step sums two scalars over the workers (``mean_tau``
  and ``nonfinite``: 2 x 2 x 4 B, two psums) that the port computes on the
  host from its tau table or leaves at a constant zero without the guard,
  so the port's async entries count 16 B and two psums fewer; and the
  reference's ``elastic/onebit_ef`` gathers the sign map and its two means
  as three collectives a leaf (39) where the port gathers two (26), the
  same bytes.  Compressed beats sync; ``wire_comparison`` flags a planted
  regression.
* The host-sync detector, the op-sequence hash, the in-place check and
  the CLI's exit codes on planted cases.
"""
import ast
import json
import pathlib
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis import lint as JL  # noqa: E402

from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis import audit, entrypoints as EP, lint  # noqa: E402
from repro_torch.analysis.findings import load_baseline  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "collective_inventory.json"
REF_FILES = sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "src" / "repro").rglob("*.py"))
PARITY_RULES = ("host-sync-in-step", "np-on-traced")
# the reference's async step sums mean_tau and nonfinite over the workers
# (two f32 scalars, twice their payload each); the port does neither
ASYNC_SCALARS = {"count": 2, "bytes": 2 * 2 * 4}
# the reference gathers a one-bit leaf as three arrays, the port as two
ONEBIT_GATHERS = {"elastic/onebit_ef": (39, 26)}


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel", REF_FILES)
def test_lint_parity_on_the_reference_tree(rel):
    tree = ast.parse((ROOT / rel).read_text())
    assert [q for q, _ in lint.hot_functions(tree)] \
        == [q for q, _ in JL.hot_functions(tree)]
    want = {(f.rule, f.where, f.line) for f in JL.lint_file(str(ROOT / rel),
                                                            rel)
            if f.rule in PARITY_RULES}
    got = {(f.rule, f.where, f.line) for f in lint.lint_file(
        str(ROOT / rel), rel)}
    assert want <= got, want - got


def _lint_src(src, tmp_path, name="mod.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return lint.lint_file(str(p), name)


def test_lint_generator_reseeded_with_the_same_seed(tmp_path):
    found = _lint_src("""
        import torch
        def sample_step(seed):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(3, generator=g)
            h = torch.Generator().manual_seed(seed)
            return a + torch.randn(3, generator=h)
        """, tmp_path)
    assert [f.rule for f in found] == ["generator-reuse"]


def test_lint_distinct_seeds_are_clean(tmp_path):
    found = _lint_src("""
        import torch
        def sample_step(seed):
            g = torch.Generator().manual_seed(seed)
            h = torch.Generator().manual_seed(seed + 1)
            return torch.randn(3, generator=g) + torch.randn(3, generator=h)
        """, tmp_path)
    assert found == []


def test_lint_global_seed_in_hot_code(tmp_path):
    found = _lint_src("""
        import torch
        def decode_step(x):
            torch.manual_seed(0)
            return x + torch.randn_like(x)
        def setup():
            torch.manual_seed(0)
        """, tmp_path)
    assert [(f.rule, f.where) for f in found] == [
        ("generator-reuse", "mod.py:decode_step")]


def test_lint_host_sync_in_step(tmp_path):
    found = _lint_src("""
        import numpy as np
        import torch
        def make_train_step(opt):
            def step(params, batch):
                loss = compute(params, batch)
                print(float(loss))
                arr = np.asarray(loss)
                host = loss.cpu().numpy()
                torch.cuda.synchronize()
                return params, loss.item()
            return step
        """, tmp_path)
    rules = sorted(f.rule for f in found)
    assert rules.count("host-sync-in-step") == 6


def test_lint_np_on_traced(tmp_path):
    found = _lint_src("""
        import numpy as np
        def decode_body(x):
            return np.exp(x) + np.prod(x.shape)
        """, tmp_path)
    assert [f.rule for f in found] == ["np-on-traced"]  # np.prod whitelisted


def test_lint_tile_misalign(tmp_path):
    found = _lint_src("""
        def kernel_call(x):
            import triton
            return launch(x, BLOCK_N=96)
        def kernel_call2(x):
            return launch(x, BLOCK=1024, tile=(8, 128))
        block = 1024
        TILE_M = 48
        """, tmp_path)
    assert sorted((f.rule, f.detail.split()[2]) for f in found) == [
        ("tile-misalign", "48"), ("tile-misalign", "96")]


def test_lint_tile_rule_needs_triton(tmp_path):
    assert _lint_src("""
        def kernel_call(x):
            return launch(x, BLOCK_N=96)
        """, tmp_path) == []


def test_lint_factory_body_not_scanned(tmp_path):
    # build-time host math in a factory body is legal; the closure is not
    found = _lint_src("""
        import numpy as np
        def make_train_step(p):
            eye = np.eye(p)
            def step(params):
                return params
            return step
        """, tmp_path)
    assert found == []


def test_hot_function_scoping():
    tree = ast.parse(textwrap.dedent("""
        def helper(): pass
        def make_thing():
            def inner(): pass
            return inner
        def train_step(): pass
        class Engine:
            def decode_once(self): pass
        """))
    names = {q for q, _ in lint.hot_functions(tree)}
    assert names == {"make_thing.inner", "train_step",
                     "Engine.decode_once"}


def test_port_lint_is_baselined():
    """Every finding over src/repro_torch is in the port's baseline, and
    every accepted entry there is justified."""
    rep = lint.run()
    assert rep.info["lint"]["files"] > 50
    baseline = load_baseline(cli.DEFAULT_BASELINE)
    new = rep.new_findings(baseline)
    assert new == [], "\n".join(str(f) for f in new)
    with open(cli.DEFAULT_BASELINE) as fh:
        entries = json.load(fh)["accepted"]
    assert entries and all(len(e["justification"]) > 40 for e in entries)


# ---------------------------------------------------------------------------
# the audit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def report():
    return audit.run(device="cpu")


def test_registry_has_the_reference_entries():
    from repro.analysis import entrypoints as JEP
    got = {e.name: (e.group, e.strategy, e.donate, e.variant is None)
           for e in EP.make_registry(1, "cpu")}
    want = {e.name: (e.group, e.strategy, e.donate, e.variant is None)
            for e in JEP.make_registry(1)}
    assert got == want


def test_wire_bytes_by_strategy_equal_the_golden(report):
    golden = json.loads(GOLDEN.read_text())
    entries = report.info["audit"]["entries"]
    for strat, want in golden["strategies"].items():
        name = want["entry"]
        got = {k: v for k, v in entries[name]["collectives"].items()
               if k != "wire_bytes"}
        want_c = {k: dict(v) for k, v in want["collectives"].items()}
        if name.startswith("async/"):
            want_c["psum"]["count"] -= ASYNC_SCALARS["count"]
            want_c["psum"]["bytes"] -= ASYNC_SCALARS["bytes"]
        if name in ONEBIT_GATHERS:
            ref_n, port_n = ONEBIT_GATHERS[name]
            assert want_c["all_gather"]["count"] == ref_n
            want_c["all_gather"]["count"] = port_n
        assert {k: (v["count"], v["bytes"]) for k, v in got.items()} == {
            k: (v["count"], v["bytes"]) for k, v in want_c.items()}, name
        assert entries[name]["collectives"]["wire_bytes"] == sum(
            v["bytes"] for v in want_c.values())


def test_compressed_beats_sync_and_a_regression_is_flagged(report):
    by = report.info["audit"]["bytes_on_wire_by_strategy"]
    for strat in audit.MUST_BEAT_SYNC:
        assert by[strat] < by["sync"], strat
    assert [f.rule for f in report.findings
            if f.rule == "compressed-not-better"] == []
    planted = {"a": {"strategy": "sync",
                     "collectives": {"wire_bytes": 100}},
               "b": {"strategy": "topk_ef",
                     "collectives": {"wire_bytes": 100}}}
    findings, _ = audit.wire_comparison(planted)
    assert [(f.rule, f.where) for f in findings] == [
        ("compressed-not-better", "strategy/topk_ef")]


def test_audit_is_clean_on_the_cpu(report):
    """No host read, no drifting op sequence, every contract realized;
    the async seed-7 twins run the same ops (the tau table is read on the
    host, but the ops it picks keep their shapes)."""
    assert report.findings == [], [str(f) for f in report.findings]
    entries = report.info["audit"]["entries"]
    for name, info in entries.items():
        if "variant_op_hash" in info:
            assert info["variant_op_hash"] == info["op_hash"], name
    assert all(entries[e.name]["in_place"]
               for e in EP.make_registry(1, "cpu") if e.donate)
    # the kernels' plain versions run where the card's kernels would
    assert entries["async/tau4_topk_ef"]["kernels"]["topk_ef"] == 13
    assert entries["async/tau4_topk_ef"]["kernels"]["topk_cr_deposit"] == 13
    assert entries["sim/ef_comp"]["kernels"]["topk_ef"] == EP._SIM_T


def _planted(fn, args=(), donate=()):
    return EP.EntryPoint("planted/step", "train", lambda: (fn, args),
                         donate=donate)


def test_host_sync_detector_catches_item_and_cpu():
    x = torch.ones(3)

    def reads(x):
        y = x * 2
        total = y.sum().item()
        return y.cpu() + total

    findings, info = audit.audit_entry(_planted(reads, (x,)))
    assert info["host_syncs"] == {"aten._local_scalar_dense": 1,
                                  "Tensor.cpu": 1}
    assert sorted(f.detail for f in findings) == [
        "device->host read 'Tensor.cpu' inside a per-step program",
        "device->host read 'aten._local_scalar_dense' inside a per-step "
        "program"]
    assert torch.Tensor.cpu is torch._C.TensorBase.cpu   # restored


def test_op_hash_is_stable_across_builds_and_sees_shapes():
    entry = EP.by_name(EP.make_registry(1, "cpu"))["elastic/topk_ef"]
    hashes = []
    for _ in range(2):
        fn, args = entry.build()
        hashes.append(audit.op_hash(audit.record_step(fn, args,
                                                      "cpu")["ops"]))
    assert hashes[0] == hashes[1]
    grow = _planted(lambda n: torch.zeros(int(n)).sum(), (3,))
    a = audit.record_step(*grow.build(), "cpu")["ops"]
    b = audit.record_step(lambda n: torch.zeros(int(n)).sum(), (4,),
                          "cpu")["ops"]
    assert audit.op_hash(a) != audit.op_hash(b)


def test_inplace_check_passes_exact_and_flags_a_rebinding():
    entry = EP.by_name(EP.make_registry(1, "cpu"))["train/exact"]
    assert audit.inplace_check(entry) == []
    params = {"w": torch.ones(4), "b": torch.zeros(2)}

    def rebinding(params, lr):
        params["w"] = params["w"] - lr       # a new tensor, not in place
        params["b"].sub_(lr)
        return params

    assert audit.inplace_check(_planted(rebinding, (params, 0.1),
                                        donate=(0,))) == [0]
    findings, info = audit.audit_entry(_planted(
        rebinding, ({"w": torch.ones(4), "b": torch.zeros(2)}, 0.1),
        donate=(0,)))
    assert [f.rule for f in findings] == ["donation-unrealized"]
    assert info["in_place"] is False


def test_broken_entry_is_a_finding():
    def boom():
        raise RuntimeError("no such step")
    rep = audit.run([EP.EntryPoint("planted/broken", "train", boom)],
                    device="cpu")
    assert [f.rule for f in rep.findings] == ["entrypoint-broken"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_all_on_the_cpu_exits_zero(tmp_path, capsys):
    out = tmp_path / "findings.json"
    assert cli.main(["--all", "--device", "cpu", "--no-compile", "--json",
                     str(out)]) == 0
    text = capsys.readouterr().out
    assert "0 NEW" in text and "bytes on wire by strategy" in text
    data = json.loads(out.read_text())
    assert data["new"] == [] and data["info"]["audit"]["device"] == "cpu"
    assert "rings" in data["info"]


def test_cli_fails_on_a_new_finding(tmp_path, capsys):
    # an empty baseline: the port's accepted lint findings are new again
    assert cli.main(["--lint", "--device", "cpu", "--baseline",
                     str(tmp_path / "none.json")]) == 1
    assert "NEW" in capsys.readouterr().out


def test_cli_fails_on_an_unjustified_baseline_entry(tmp_path, capsys):
    with open(cli.DEFAULT_BASELINE) as fh:
        data = json.load(fh)
    data["accepted"][0]["justification"] = "TODO: justify or fix"
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(data))
    assert cli.main(["--lint", "--device", "cpu", "--baseline",
                     str(path)]) == 1
    assert "UNJUSTIFIED" in capsys.readouterr().out


def test_cli_refuses_to_baseline_without_a_justification(tmp_path):
    path = tmp_path / "baseline.json"
    assert cli.main(["--lint", "--device", "cpu", "--baseline", str(path),
                     "--update-baseline"]) == 1
    assert not path.exists()
    assert cli.main(["--lint", "--device", "cpu", "--baseline", str(path),
                     "--update-baseline", "--justify",
                     "launch-time code, reviewed"]) == 0
    assert cli.main(["--lint", "--device", "cpu", "--baseline",
                     str(path)]) == 0


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--lint"])
