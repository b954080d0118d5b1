"""The port's static analyzer (``repro_torch.analysis``) against the
reference's (``repro.analysis``).

Both analyzers run on the same problems, layouts, trees and caches, and
their reports must be equal: passes, rule ids, severities, arrays, loci,
messages (the bandwidth metrics among them) and hints.  One finding is
left out of the comparison on purpose: the reference warns
``extraction/host-fallback`` for pieces wider than 32 bits, which its
host decodes; the port decodes them on the card and does not emit it
(ROADMAP §C).  Each of the reference's twelve mutation classes must be
found by the port under the reference's rule ids, with the reference's
report.  Everything runs on the CPU; no test needs a card.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from _torch_trees import (  # noqa: E402
    configs_and_params,
    filled_kv,
    ref_kv_like,
    trees,
)

import repro.analysis as ref_an  # noqa: E402
import repro_torch.analysis as port_an  # noqa: E402
from repro import api as ref_api  # noqa: E402
from repro.analysis import mutations as ref_mut  # noqa: E402
from repro.analysis import suite as ref_suite  # noqa: E402
from repro.analysis.__main__ import main as ref_main  # noqa: E402
from repro.checkpoint.checkpoint import CheckpointManager as RefMgr  # noqa: E402
from repro.core.exec_plan import lower_exec as ref_lower  # noqa: E402
from repro.tree import LayoutManifest as RefManifest  # noqa: E402
from repro_torch import api as port_api  # noqa: E402
from repro_torch.analysis import mutations as port_mut  # noqa: E402
from repro_torch.analysis import suite as port_suite  # noqa: E402
from repro_torch.analysis.__main__ import main as port_main  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.exec_plan import lower_exec as port_lower  # noqa: E402
from repro_torch.tree import LayoutManifest  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the one rule the port does not emit (its card decodes wide pieces)
HOST_FALLBACK = "extraction/host-fallback"

STRATEGIES = port_api.strategies()
GATE_IDS = [f"m{p.m}-" + "".join(a.name[0] for a in p.arrays)
            for p in port_suite.GATE_PROBLEMS]
#: the non-power-of-two, all-kernel-width problem of the mutations
MUT = 1


def _without_host_fallback(d: dict) -> dict:
    """A reference report's JSON with the host-fallback warnings taken
    out (and the counts that include them)."""
    d = dict(d)
    d["findings"] = [f for f in d["findings"] if f["rule_id"] != HOST_FALLBACK]
    d["n_warnings"] = sum(f["severity"] == "warning" for f in d["findings"])
    return d


def _same_report(port, ref) -> None:
    assert port.to_json_dict() == _without_host_fallback(ref.to_json_dict())


@pytest.fixture(scope="module")
def models():
    return configs_and_params()


@pytest.fixture(scope="module")
def packed(models):
    return {bits: trees(models, bits) for bits in (3, 4)}


@pytest.fixture(scope="module")
def lowered():
    """The mutation problem planned and lowered by each package."""
    rlay = ref_api.plan(ref_suite.GATE_PROBLEMS[MUT], cache=None).layout
    play = port_api.plan(port_suite.GATE_PROBLEMS[MUT], cache=None).layout
    return (rlay, ref_lower(rlay)), (play, port_lower(play))


# ----------------------------------------------------------------------
# the findings model
# ----------------------------------------------------------------------
def _both_reports():
    out = []
    for an in (ref_an, port_an):
        r = an.Report(subject="t")
        r.findings.append(an.Finding("p/x", an.Severity.ERROR, "boom",
                                     array="a", locus="piece 3",
                                     fixit_hint="re-lower"))
        r.findings.append(an.Finding("p/y", an.Severity.INFO, "fyi"))
        out.append(r)
    return out


def test_report_api_matches_reference():
    ref, port = _both_reports()
    assert port_an.Severity.INFO < port_an.Severity.WARNING \
        < port_an.Severity.ERROR
    assert str(port_an.Severity.ERROR) == "error"
    assert port.to_json_dict() == ref.to_json_dict()
    assert port.to_json() == ref.to_json()
    assert json.loads(port.to_json()) == port.to_json_dict()
    for sev in port_an.Severity:
        assert port.render(sev) == ref.render(ref_an.Severity(int(sev)))
    assert "p/y" not in port.render(port_an.Severity.WARNING)
    assert port.rule_ids() == {"p/x", "p/y"} and not port.ok
    assert len(port.errors) == 1 and len(port.warnings) == 0


def test_raise_if_errors_chains_and_raises_like_reference():
    clean = port_an.Report()
    assert clean.raise_if_errors() is clean
    ref, port = _both_reports()
    with pytest.raises(port_an.AnalysisError) as pe:
        port.raise_if_errors()
    with pytest.raises(ref_an.AnalysisError) as re_:
        ref.raise_if_errors()
    assert pe.value.report is port
    assert str(pe.value) == str(re_.value)
    assert isinstance(pe.value, ValueError)


def test_unknown_pass_rejected():
    from repro_torch.analysis.passes import AnalysisContext, run_passes

    with pytest.raises(KeyError, match="registered"):
        run_passes(AnalysisContext(), ["no-such-pass"])
    assert list(port_an.PASSES) == list(ref_an.PASSES)
    assert port_an.LAYOUT_ONLY_PASSES == ref_an.LAYOUT_ONLY_PASSES
    assert port_an.KVCACHE_PASSES == ref_an.KVCACHE_PASSES


def test_suite_problems_match_reference():
    for name in ("EXEC_PROBLEMS", "DECODE_PROBLEMS", "GATE_PROBLEMS"):
        port, ref = getattr(port_suite, name), getattr(ref_suite, name)
        assert [p.canonical_signature() for p in port] == \
            [p.canonical_signature() for p in ref], name
    assert port_suite.GOLDEN_PROBLEM.canonical_signature() == \
        ref_suite.GOLDEN_PROBLEM.canonical_signature()
    assert STRATEGIES == ref_api.strategies()


# ----------------------------------------------------------------------
# the clean gate: every strategy x problem, report for report
# ----------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("i", range(len(port_suite.GATE_PROBLEMS)),
                         ids=GATE_IDS)
def test_gate_report_matches_reference(strategy, i):
    rlay = ref_api.plan(ref_suite.GATE_PROBLEMS[i], strategy,
                        cache=None).layout
    play = port_api.plan(port_suite.GATE_PROBLEMS[i], strategy,
                         cache=None).layout
    ref = ref_an.verify_layout(rlay, subject=strategy)
    port = port_an.verify_layout(play, subject=strategy)
    assert port.ok, port.render()
    _same_report(port, ref)
    fast = port_an.verify_layout_fast(play, subject=strategy)
    _same_report(fast, ref_an.verify_layout_fast(rlay, subject=strategy))


def test_host_fallback_is_the_only_difference():
    """GATE_PROBLEMS[2] (33- and 64-bit arrays): the reference warns that
    its host decodes them; the port, which decodes them on the card as
    two u32 fields, does not, and agrees on everything else."""
    rlay = ref_api.plan(ref_suite.GATE_PROBLEMS[2], cache=None).layout
    play = port_api.plan(port_suite.GATE_PROBLEMS[2], cache=None).layout
    ref, port = ref_an.verify_layout(rlay), port_an.verify_layout(play)
    assert HOST_FALLBACK in {f.rule_id for f in ref.warnings}
    assert HOST_FALLBACK not in port.rule_ids()
    assert {f.array for f in ref if f.rule_id == HOST_FALLBACK} == {"c", "d"}
    _same_report(port, ref)


def test_plan_verify_chains_and_raises(lowered):
    rp = ref_api.plan(ref_suite.GATE_PROBLEMS[MUT], cache=None)
    pp = port_api.plan(port_suite.GATE_PROBLEMS[MUT], cache=None)
    report = pp.verify()
    assert report.ok and {"interval", "program"} <= set(report.passes)
    _same_report(report, rp.verify())
    sub = pp.verify(passes=["interval", "bandwidth"])
    assert sub.passes == ["interval", "bandwidth"]
    # a corrupted lowering is refused, naming the rule
    rp._exec_program = ref_mut.corrupt_program(rp.exec_program, "overlap")
    pp._exec_program = port_mut.corrupt_program(pp.exec_program, "overlap")
    with pytest.raises(port_an.AnalysisError) as pe:
        pp.verify()
    assert "program/overlap" in pe.value.report.rule_ids()
    _same_report(pp.verify(raise_on_error=False),
                 rp.verify(raise_on_error=False))


# ----------------------------------------------------------------------
# the mutation harness
# ----------------------------------------------------------------------
def test_mutation_registries_match_reference():
    assert port_mut.PROGRAM_MUTATIONS == ref_mut.PROGRAM_MUTATIONS
    assert port_mut.CHECKPOINT_MUTATIONS == ref_mut.CHECKPOINT_MUTATIONS
    assert len(port_mut.PROGRAM_MUTATIONS) + \
        len(port_mut.CHECKPOINT_MUTATIONS) == 12


@pytest.mark.parametrize("kind", sorted(port_mut.PROGRAM_MUTATIONS))
def test_program_mutation_found_like_reference(kind, lowered):
    (rlay, rprog), (play, pprog) = lowered
    port = port_an.verify_program(port_mut.corrupt_program(pprog, kind),
                                  layout=play)
    ref = ref_an.verify_program(ref_mut.corrupt_program(rprog, kind),
                                layout=rlay)
    assert not port.ok, f"{kind} went undetected"
    assert {f.rule_id for f in port.errors} \
        & set(port_mut.PROGRAM_MUTATIONS[kind])
    _same_report(port, ref)


@pytest.mark.parametrize("kind", sorted(port_mut.CHECKPOINT_MUTATIONS))
@pytest.mark.parametrize("bits", [3, 4])
def test_checkpoint_mutation_found_like_reference(kind, bits, packed):
    rt, pt = packed[bits]
    streams = pt.streams.numpy()
    digest = port_an.stream_sha256(streams)
    assert digest == ref_an.stream_sha256(np.asarray(rt.streams))
    d, s, g = port_mut.corrupt_checkpoint(pt.manifest.to_json_dict(),
                                          streams, digest, kind)
    rd, rs, rg = ref_mut.corrupt_checkpoint(rt.manifest.to_json_dict(),
                                            np.asarray(rt.streams), digest,
                                            kind)
    assert d == rd and np.array_equal(s, rs) and g == rg
    port = port_an.verify_manifest(LayoutManifest.from_json_dict(d),
                                   streams=s, stream_digest=g)
    ref = ref_an.verify_manifest(RefManifest.from_json_dict(rd),
                                 streams=rs, stream_digest=rg)
    assert not port.ok, f"{kind} went undetected"
    assert {f.rule_id for f in port.errors} \
        & set(port_mut.CHECKPOINT_MUTATIONS[kind])
    _same_report(port, ref)


def test_mutations_leave_the_original_untouched(lowered, packed):
    _ref, (play, pprog) = lowered
    tables = (pprog.word.copy(), pprog.shift.copy(), pprog.kernel.tab.copy(),
              [g.copy() for _, g in pprog.kernel.gathers])
    for kind in port_mut.PROGRAM_MUTATIONS:
        port_mut.corrupt_program(pprog, kind)
    assert np.array_equal(pprog.word, tables[0])
    assert np.array_equal(pprog.shift, tables[1])
    assert np.array_equal(pprog.kernel.tab, tables[2])
    assert all(np.array_equal(g, h) for (_, g), h
               in zip(pprog.kernel.gathers, tables[3]))
    assert port_an.verify_program(pprog, layout=play).ok
    _rt, pt = packed[3]
    man = pt.manifest.to_json_dict()
    before = json.dumps(man)
    streams = pt.streams.numpy()
    copy = streams.copy()
    digest = port_an.stream_sha256(streams)
    for kind in port_mut.CHECKPOINT_MUTATIONS:
        port_mut.corrupt_checkpoint(man, streams, digest, kind)
    assert json.dumps(man) == before and np.array_equal(streams, copy)
    assert port_an.verify_manifest(pt.manifest, streams=streams,
                                   stream_digest=digest).ok


def test_unknown_mutation_kind_refused(lowered, packed):
    _ref, (_play, pprog) = lowered
    with pytest.raises(KeyError, match="unknown program mutation"):
        port_mut.corrupt_program(pprog, "no-such-mutation")
    _rt, pt = packed[3]
    with pytest.raises(KeyError, match="unknown checkpoint mutation"):
        port_mut.corrupt_checkpoint(pt.manifest.to_json_dict(),
                                    pt.streams.numpy(), "", "no-such")


# ----------------------------------------------------------------------
# trees, caches and manifests
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bits", [3, 4])
def test_tree_verify_matches_reference(bits, packed):
    rt, pt = packed[bits]
    report = pt.verify()                         # raises on errors
    assert report.ok
    assert {"interval", "program", "kernel", "stream", "extraction",
            "manifest", "bandwidth"} <= set(report.passes)
    _same_report(report, rt.verify())
    _same_report(port_an.verify_manifest(pt.manifest),
                 ref_an.verify_manifest(rt.manifest))


@pytest.mark.parametrize("bits", [3, 4])
def test_kvcache_verify_matches_reference(bits, models):
    kvc = filled_kv(models[1], bits)
    ref_kvc = ref_kv_like(kvc)
    digest = port_an.stream_sha256(kvc.host_pages())
    report = kvc.verify(pages_digest=digest)
    assert report.ok and report.passes == list(port_an.KVCACHE_PASSES)
    _same_report(report, ref_kvc.verify(pages_digest=digest))
    # a stray bit outside the payload and a wrong digest are refused
    kvc.pages[0, 0, 3, 0, kvc.manifest.words32 - 1] |= 1 << 30
    bad = kvc.verify(pages_digest=digest)
    ref_bad = ref_kv_like(kvc).verify(pages_digest=digest)
    assert {"kvcache/pages-digest", "kvcache/stray-bits"} <= \
        {f.rule_id for f in bad.errors}
    _same_report(bad, ref_bad)


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_gate_writes_the_reference_artifact(tmp_path, capsys):
    out, ref_out = tmp_path / "gate.json", tmp_path / "ref_gate.json"
    rc = port_main(["--json", str(out), "gate"])
    ref_rc = ref_main(["--json", str(ref_out), "gate"])
    assert rc == ref_rc == 0
    port, ref = json.loads(out.read_text()), json.loads(ref_out.read_text())
    assert port["n_reports"] == len(STRATEGIES) * \
        len(port_suite.GATE_PROBLEMS)
    ref["reports"] = [_without_host_fallback(r) for r in ref["reports"]]
    ref["n_warnings"] = sum(r["n_warnings"] for r in ref["reports"])
    assert port == ref
    assert "OK" in capsys.readouterr().out


def test_config_exit_code_matches_reference(capsys):
    argv = ["config", "smollm-135m", "--bits", "4", "--layers", "1"]
    assert port_main(argv) == ref_main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("OK") >= 2
    argv = ["--min-severity", "info", "config", "smollm-135m", "--bits", "3",
            "--group-size", "32", "--layers", "1", "--strategy",
            "homogeneous"]
    assert port_main(argv) == ref_main(argv) == 0


def test_ckpt_exit_codes_match_reference(tmp_path, packed, models):
    rt, pt = packed[3]
    kvc = filled_kv(models[1], 3)
    roots = {}
    for name, mgr_cls, tree, kv in (
            ("port", CheckpointManager, pt, kvc),
            ("ref", RefMgr, rt, ref_kv_like(kvc))):
        roots[name] = tmp_path / name
        mgr_cls(roots[name]).save_packed(0, tree, kv=kv)
    for name in ("port", "ref"):
        argv = ["ckpt", str(roots[name])]
        assert port_main(argv) == ref_main(argv) == 0
    # a flipped stream bit: exit 1 from both, under the digest rule
    d = roots["port"] / "step_00000000"
    meta = json.loads((d / "manifest.json").read_text())
    f = d / f"arr_{meta['paths'].index('streams'):05d}.npy"
    arr = np.load(f)
    arr.flat[7] ^= np.uint8(0x10)
    np.save(f, arr)
    js, ref_js = tmp_path / "ckpt.json", tmp_path / "ref_ckpt.json"
    assert port_main(["--json", str(js), "ckpt", str(roots["port"])]) == 1
    assert ref_main(["--json", str(ref_js), "ckpt", str(roots["port"])]) == 1
    port, ref = json.loads(js.read_text()), json.loads(ref_js.read_text())
    assert port == ref
    assert "manifest/stream-digest" in \
        {f["rule_id"] for f in port["reports"][0]["findings"]}


def test_new_modules_import_no_jax_repro_or_ml_dtypes():
    code = (
        "import sys\n"
        "import repro_torch.analysis, repro_torch.analysis.__main__\n"
        "import repro_torch.analysis.mutations, repro_torch.checkpoint\n"
        "import repro_torch.engine.streams\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_python_m_runs_the_gate(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json",
         str(tmp_path / "g.json"), "gate", "--strategies", "iris"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads((tmp_path / "g.json").read_text())
    assert payload["ok"] and payload["n_reports"] == \
        len(port_suite.GATE_PROBLEMS)
