"""PyTorch port's lint (``repro_torch.analysis``): per-rule good/bad fixtures
(the reference's families and the eager-PyTorch device rules T101-T103),
noqa suppression, the baseline round trip, CLI exit codes, the port's
sweep clean under ``.repro-torch-lint-baseline``, and the shared families
held against the reference's engine finding for finding.

Like the reference's lint tests, these import neither torch nor numpy."""
import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import Baseline, lint_paths
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.rules import all_rules, rule_ids

REPO = Path(__file__).resolve().parents[1]


def _write(tmp_path: Path, rel: str, src: str) -> Path:
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def _findings(tmp_path, rel, src, rule_id=None):
    p = _write(tmp_path, rel, src)
    res = lint_paths([str(p)])
    if rule_id is None:
        return res.findings
    return [f for f in res.findings if f.rule == rule_id]


def _reference_fixtures():
    import test_analysis
    return test_analysis.BAD_FIXTURES, test_analysis.GOOD_FIXTURES


SHARED = ("REPRO-D001", "REPRO-D002", "REPRO-D003", "REPRO-C201",
          "REPRO-C202", "REPRO-C203", "REPRO-W301", "REPRO-W302")

# the eager-PyTorch device rules: for each, a firing bad case and a clean
# good case; paths mimic the real tree so rule scoping is exercised too
DEVICE_BAD = {
    "REPRO-T101": ("core/gp.py", """
        import torch

        def score(c, rows, idx):
            v = torch.exp(c)
            avail = torch.ones(c.shape, dtype=torch.bool)
            avail[rows, idx] = False
            best = float(v.max())
            sub = torch.nonzero(v > best)
            return v.cpu().numpy(), v.sum().item(), sub
        """),
    "REPRO-T102": ("core/scoring.py", """
        import torch

        def absorb(n_pending: torch.Tensor, ps):
            for j in range(ps.shape[1]):
                sub = torch.nonzero(n_pending > j)[:, 0]
                if not len(sub):
                    break
            if n_pending.any():
                return ps
        """),
    "REPRO-T103": ("kernels/foo/ops.py", """
        import torch

        from repro_torch.kernels.foo import ref

        def run(x):
            dev = "cuda" if torch.cuda.is_available() else "cpu"
            try:
                return ops.launch(x.to(dev))
            except RuntimeError:
                return ref.launch_ref(x)
        """),
}

DEVICE_GOOD = {
    "REPRO-T101": ("core/gp.py", """
        import numpy as np
        import torch

        from repro_torch.analysis.sanitizers import to_host

        def score(c, rows, idx):
            v = torch.exp(c)
            avail = torch.ones(c.shape, dtype=torch.bool)
            avail[rows, idx] = torch.zeros((), dtype=torch.bool)
            avail[0] = False
            n = int(v.shape[0]) + v.numel()
            rows = np.nonzero(np.arange(4) > 1)[0].tolist()
            return to_host(v), n, rows
        """),
    "REPRO-T102": ("core/scoring.py", """
        import numpy as np
        import torch

        def absorb(counts, ps: torch.Tensor):
            for j in range(ps.shape[1]):
                rows = np.nonzero(counts > j)[0]
                if not len(rows):
                    break
            if ps.shape[0] > 2 and ps.dtype is not None and len(ps):
                return torch.where(ps > 0, ps, 0.0)
        """),
    "REPRO-T103": ("kernels/foo/ops.py", """
        from repro_torch.device import resolve_device

        def run(x, device=None):
            dev = resolve_device(device)
            if dev.type == "cpu":
                return ref.launch_ref(x)
            return ops.launch(x)
        """),
}


def _bad(rule_id):
    return (DEVICE_BAD[rule_id] if rule_id in DEVICE_BAD
            else _reference_fixtures()[0][rule_id])


def _good(rule_id):
    return (DEVICE_GOOD[rule_id] if rule_id in DEVICE_GOOD
            else _reference_fixtures()[1][rule_id])


# --------------------------------------------------------------------------- #
# fixtures: every rule fires on its bad case and stays quiet on its good one
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rule_id", sorted(SHARED + tuple(DEVICE_BAD)))
def test_bad_fixture_fires(tmp_path, rule_id):
    rel, src = _bad(rule_id)
    assert _findings(tmp_path, rel, src, rule_id), \
        f"{rule_id} bad fixture produced no finding"


@pytest.mark.parametrize("rule_id", sorted(SHARED + tuple(DEVICE_GOOD)))
def test_good_fixture_is_clean(tmp_path, rule_id):
    rel, src = _good(rule_id)
    found = _findings(tmp_path, rel, src, rule_id)
    assert not found, f"{rule_id} good fixture fired: {found}"


def test_every_registered_rule_has_a_firing_bad_fixture():
    """Meta-test: adding a rule without fixtures fails here."""
    ids = set(rule_ids())
    assert ids == set(SHARED) | set(DEVICE_BAD)
    assert ids == set(SHARED) | set(DEVICE_GOOD)


def test_t101_flags_each_hidden_sync_of_its_bad_fixture(tmp_path):
    """The scalar store, float(), torch.nonzero, .cpu() and .item(): one
    finding each (``.numpy()`` after ``.cpu()`` is the same read)."""
    rel, src = DEVICE_BAD["REPRO-T101"]
    found = _findings(tmp_path, rel, src, "REPRO-T101")
    assert sorted(f.line for f in found) == [7, 8, 9, 10, 10]


def test_t102_flags_len_of_nonzero_and_if_on_a_tensor(tmp_path):
    rel, src = DEVICE_BAD["REPRO-T102"]
    found = _findings(tmp_path, rel, src, "REPRO-T102")
    assert [f.line for f in found] == [7, 9]


def test_t103_flags_the_cpu_choice_and_the_ref_handler(tmp_path):
    rel, src = DEVICE_BAD["REPRO-T103"]
    found = _findings(tmp_path, rel, src, "REPRO-T103")
    assert [f.line for f in found] == [7, 10]


def test_t103_flags_cpu_chosen_in_an_except_handler(tmp_path):
    src = """
        import torch

        def place(x):
            try:
                return x.to("cuda")
            except RuntimeError:
                return x.to("cpu")
        """
    assert _findings(tmp_path, "core/gp.py", src, "REPRO-T103")


def test_rules_scope_to_their_directories(tmp_path):
    """The same offending source outside a rule's scope is not flagged."""
    _, src = _bad("REPRO-D001")
    assert not _findings(tmp_path, "viz/plots.py", src, "REPRO-D001")
    for rule_id in DEVICE_BAD:
        _, src = DEVICE_BAD[rule_id]
        assert not _findings(tmp_path, "core/plots.py", src, rule_id)


# --------------------------------------------------------------------------- #
# noqa suppression
# --------------------------------------------------------------------------- #
def test_noqa_with_rule_id_suppresses(tmp_path):
    src = """
        import torch

        def f(x):
            return torch.exp(x).item()  # repro: noqa REPRO-T101
        """
    assert not _findings(tmp_path, "core/gp.py", src, "REPRO-T101")


def test_bare_noqa_suppresses_everything_on_the_line(tmp_path):
    src = """
        import time

        def deadline():
            return time.time() + 5.0  # repro: noqa
        """
    assert not _findings(tmp_path, "core/a.py", src)


def test_noqa_for_other_rule_does_not_suppress(tmp_path):
    src = """
        import torch

        def f(x):
            return torch.exp(x).item()  # repro: noqa REPRO-D001
        """
    assert _findings(tmp_path, "core/gp.py", src, "REPRO-T101")


# --------------------------------------------------------------------------- #
# baseline round-trip
# --------------------------------------------------------------------------- #
def test_baseline_roundtrip_add_suppress_stale(tmp_path):
    rel, src = DEVICE_BAD["REPRO-T102"]
    p = _write(tmp_path, rel, src)
    res = lint_paths([str(p)])
    assert res.findings and not res.ok

    bl_path = tmp_path / "baseline.json"
    Baseline.from_findings(res.findings, note="known sync").save(str(bl_path))
    bl = Baseline.load(str(bl_path))
    res2 = lint_paths([str(p)], baseline=bl)
    assert res2.ok
    assert len(res2.baselined) == len(res.findings)
    assert not res2.stale

    # line-number churn keeps every entry matching ...
    p.write_text("# moved\n" + p.read_text())
    res3 = lint_paths([str(p)], baseline=bl)
    assert res3.ok and not res3.stale

    # ... and repairing the offending lines turns their entries stale
    rel, good = DEVICE_GOOD["REPRO-T102"]
    p.write_text(textwrap.dedent(good))
    res4 = lint_paths([str(p)], baseline=bl)
    assert res4.ok
    assert len(res4.stale) == len(bl.entries)


def test_unparsable_file_is_an_error(tmp_path):
    p = _write(tmp_path, "core/broken.py", "def f(:\n")
    res = lint_paths([str(p)])
    assert res.errors and not res.ok


# --------------------------------------------------------------------------- #
# CLI exit contract
# --------------------------------------------------------------------------- #
def test_cli_exit_codes(tmp_path, capsys):
    rel, src = DEVICE_BAD["REPRO-T101"]
    bad = _write(tmp_path, rel, src)
    assert cli_main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "REPRO-T101" in out

    bl = tmp_path / "bl.json"
    assert cli_main([str(bad), "--write-baseline", str(bl)]) == 0
    assert cli_main([str(bad), "--baseline", str(bl)]) == 0
    assert cli_main([str(bad), "--baseline", str(tmp_path / "nope")]) == 2

    good = _write(tmp_path, "core/clean.py", "X = 1\n")
    assert cli_main([str(good)]) == 0
    assert cli_main(["--list-rules"]) == 0
    assert "REPRO-T103" in capsys.readouterr().out


def test_cli_json_format(tmp_path, capsys):
    rel, src = _bad("REPRO-C203")
    bad = _write(tmp_path, rel, src)
    assert cli_main([str(bad), "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["unbaselined"]
    assert payload["unbaselined"][0]["rule"] == "REPRO-C203"


def test_cli_defaults_to_the_port(monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    assert cli_main(["--baseline", ".repro-torch-lint-baseline"]) == 0
    assert "0 finding(s), 3 baselined, 0 stale" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# the port itself stays clean
# --------------------------------------------------------------------------- #
def test_port_sweep_clean_under_committed_baseline():
    bl = Baseline.load(str(REPO / ".repro-torch-lint-baseline"))
    res = lint_paths([str(REPO / "src" / "repro_torch")], baseline=bl)
    assert res.ok, [f.format() for f in res.unbaselined] + res.errors
    assert not res.stale, res.stale
    for e in bl.entries:
        assert e["note"] and "TODO" not in e["note"], e


def test_rule_metadata_complete():
    for rule in all_rules():
        assert rule.id.startswith("REPRO-")
        assert rule.family and rule.description and rule.rationale
        assert rule.scopes  # every current rule is repo-scoped


# --------------------------------------------------------------------------- #
# held against the reference's engine
# --------------------------------------------------------------------------- #
def _keys(res):
    return sorted((f.rule, f.path, f.line, f.content) for f in res.findings)


def _shared_rules(pkg_rules):
    return [r for r in pkg_rules() if r.id in SHARED]


@pytest.mark.parametrize("kind", ["bad", "good"])
def test_shared_families_equal_the_reference_on_its_fixtures(tmp_path,
                                                             kind):
    from repro.analysis import lint_paths as j_lint_paths
    from repro.analysis.rules import all_rules as j_all_rules

    fixtures = _reference_fixtures()[0 if kind == "bad" else 1]
    for rule_id in SHARED:
        rel, src = fixtures[rule_id]
        p = _write(tmp_path / rule_id, rel, src)
        got = lint_paths([str(p)], rules=_shared_rules(all_rules))
        want = j_lint_paths([str(p)], rules=_shared_rules(j_all_rules))
        assert _keys(got) == _keys(want), rule_id


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_shared_families_equal_the_reference_on_the_trees(tree):
    from repro.analysis import lint_paths as j_lint_paths
    from repro.analysis.rules import all_rules as j_all_rules

    path = str(REPO / "src" / tree)
    got = lint_paths([path], rules=_shared_rules(all_rules))
    want = j_lint_paths([path], rules=_shared_rules(j_all_rules))
    assert _keys(got) == _keys(want)
    assert [r.id for r in _shared_rules(all_rules)] == sorted(SHARED)
