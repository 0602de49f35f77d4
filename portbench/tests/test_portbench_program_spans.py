"""The program's records lined up with the window's asks
(``program_spans``): made-up records, and a traced tiny run of each cell
on the CPU reading every metric that reads them."""
from types import SimpleNamespace

import pytest

from portbench import harness, program_spans

READERS = ("ask_draw_ms", "fit_wall_ms", "factors_ms", "factors_copy_ms",
           "pick_wall_ms", "register_ms", "ask_self_ms", "d2h_mb_per_ask",
           "fit_useful_pct")


def _rec(ask, profiled=False, bank=1, root="ask", draw_ms=2.0, due=2):
    t = 1_000_000 * ask * 100
    spans = [[root, -1, t, t + 10_000_000, None],
             ["ask.draw", 0, t + 1_000_000, t + 1_000_000 + int(draw_ms * 1e6),
              None],
             ["ask.pick", 0, t + 5_000_000, t + 6_000_000, "gp"],
             ["ask.pick", 0, t + 6_000_000, t + 8_000_000, "cluster"]]
    return SimpleNamespace(ask=ask, bank=bank, profiled=profiled, spans=spans,
                           counters={"d2h_bytes": 3_000_000, "fit_rows": 4,
                                     "due_rows": due})


def _ctx(rounds, profiled_rounds=()):
    asks = [{"round": r} for r in rounds]
    prof = ({"asks": [{"round": r} for r in profiled_rounds]}
            if profiled_rounds else None)
    return {"asks": asks, "profile": prof}


def test_profiled_rounds_are_dropped_and_the_last_asks_taken():
    # two warm asks and another bank's view ask before the window
    recs = [_rec(1), _rec(2), _rec(3, root="ask_view", bank=2)]
    recs += [_rec(4 + r, profiled=r in (1, 2), draw_ms=1.0 + r)
             for r in range(5)]
    ctx = _ctx(range(5), profiled_rounds=(1, 2))
    got = program_spans.window_records(ctx, recs)
    assert [r.ask for r in got] == [4, 7, 8]
    assert program_spans.mean_span_ms(ctx, "ask.draw", recs) == \
        pytest.approx((1.0 + 4.0 + 5.0) / 3)
    assert program_spans.mean_span_ms(ctx, "ask.pick", recs) == \
        pytest.approx(3.0)
    assert program_spans.mean_self_ms(ctx, recs) == pytest.approx(10.0 - (
        (1.0 + 4.0 + 5.0) / 3) - 3.0)
    assert program_spans.counter_sums(ctx, ("due_rows", "fit_rows"),
                                      recs) == ([6, 12], 3)


@pytest.mark.parametrize("case", ["gap", "profile_mismatch", "two_banks",
                                  "too_few", "none"])
def test_records_that_do_not_line_up_give_none(case):
    recs = [_rec(10 + r, profiled=r == 1) for r in range(4)]
    ctx = _ctx(range(4), profiled_rounds=(1,))
    if case == "gap":
        recs[2] = _rec(20)
    elif case == "profile_mismatch":
        ctx = _ctx(range(4), profiled_rounds=(2,))
    elif case == "two_banks":
        recs[3] = _rec(13, bank=9)
    elif case == "too_few":
        ctx = _ctx(range(5), profiled_rounds=(1,))
    else:
        recs = []
    assert program_spans.window_records(ctx, recs) is None
    assert program_spans.mean_span_ms(ctx, "ask.draw", recs) is None
    assert program_spans.counter_sums(ctx, ("fit_rows",), recs) is None


@pytest.mark.parametrize("cell,useful", [("gp_bucb.long.staggered", 50.0),
                                         ("clustering.long.staggered", 50.0),
                                         ("gp_bucb.long.lockstep", 100.0)])
def test_a_traced_tiny_run_reads_the_programs_metrics(cell, useful):
    from portbench_tiny import tiny_run
    res = tiny_run(cell, seconds=1.5, trace=True)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(got)
    for name in READERS:
        assert got[name] is not None and got[name] >= 0.0, name
    assert got["fit_useful_pct"] == useful
    # L and L^-1 of 4 studies at the 64-row bucket, and the rest
    assert got["d2h_mb_per_ask"] == pytest.approx(2 * 4 * 64 * 64 * 4 / 1e6,
                                                  rel=0.01)
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert cell in entries[name]["workloads"]
        assert entries[name]["moves"] == "ask_p90_ms"


def test_a_traced_tiny_tpe_run_reads_its_metrics():
    """The TPE cell has no fit: its traced run reads the draw, pick,
    register and exit spans and the whole ask's share, and none of the fit's
    metrics is listed for it."""
    from portbench_tiny import load_bench, tiny_run
    cell = "tpe.h6.long"
    res = tiny_run(cell, seconds=1.5, trace=True)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("ask_draw_ms", "pick_wall_ms", "register_ms",
                 "ask_self_ms", "ask_mfu_pct"):
        assert got[name] > 0.0, name
    # the picks of 4 studies, 4 int64 indices each
    assert got["d2h_mb_per_ask"] == pytest.approx(4 * 4 * 8 / 1e6)
    bench = load_bench()
    listed = {m["name"] for m in harness.metric_entries(bench, cell)}
    assert not listed & {"fit_ms", "fit_wall_ms", "factors_ms",
                         "factors_copy_ms", "fit_useful_pct",
                         "score_cov_roofline", "var_downdate_roofline"}
    assert "tpe_scores_roofline" in listed
