"""The port's continuous-batching serve loop (``repro_torch.launch.
serve_loop``) against the reference's (``repro.launch.serve_loop``), and
over real port sessions on the CPU.

* Scheduler parity: every scripted scenario of tests/test_serve_loop.py
  runs through both modules with the same fake executor and a
  ``VirtualClock``: traces, ticket timelines, results, completion order
  and ``summary()`` must be equal; the refusals too; ``percentile`` is
  numpy's.
* Real sessions (QueryStream 40 × 200, tol 1e-6, ``hi_frac`` 0.95):
  served masks bit for bit the direct ``session.path`` call for fill,
  pow-2-padded drain and 1-live batches; against the reference's serve
  loop over its own session on the same stream, the same trace, masks
  equal outside the 1e-4 band of the threshold (counted) and β within
  ``beta_err_tol``; a NaN query isolated with the reference's trace
  ``fill, isolate×4``; ``max_iter=2`` flags every ticket unconverged.
* A NaN query is refused by both packages, single and (B, n): it is what
  lets the loop isolate a poisoned batch.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import LassoSession as JSession
from repro.core import PathConfig as JConfig
from repro.core import ScreeningEngine as JEngine
from repro.core import SolveSpec as JSolve
from repro.core import screening as jscr
from repro.launch import serve_loop as jsl
from repro_torch import LassoSession, PathConfig, SolveSpec
from repro_torch.data import QueryStream
from repro_torch.launch import serve_loop as tsl

MODULES = {"reference": jsl, "port": tsl}
N, P = 40, 200
TOL = 1e-6
BAND = 1e-4
K = 5


def beta_err_tol(y, solver_tol, kappa=25.0):
    """benchmarks/common.py: two gap-ε solutions differ by ≤ this."""
    y = np.asarray(y, np.float64)
    return kappa * float(np.sqrt(solver_tol * 0.5 * float(y @ y)))


# ---------------------------------------------------------------------------
# scheduler parity
# ---------------------------------------------------------------------------

class FakeExecutor:
    """tests/test_serve_loop.py's executor over either module's handles:
    each live lane's result is its own query row, convergence is scripted
    by content, and a batch with a non-finite row fails wholesale when
    ``fail_on_nan``."""

    def __init__(self, sl, *, fail_on_nan=False, unconverged_mark=None):
        self.sl = sl
        self.fail_on_nan = fail_on_nan
        self.unconverged_mark = unconverged_mark

    def dispatch(self, Y, n_live, batch_id, now):
        Y = np.asarray(Y)
        if self.fail_on_nan and not np.isfinite(Y[:n_live]).all():
            return self.sl.ImmediateHandle(
                failure=ValueError("poisoned lambda grid"))
        lanes = []
        for b in range(n_live):
            conv = not (self.unconverged_mark is not None
                        and Y[b, 0] == self.unconverged_mark)
            lanes.append(self.sl.LaneResult(result=Y[b].copy(),
                                            converged=conv))
        return self.sl.ImmediateHandle(lanes=lanes)


def qrow(i, n=4):
    return np.full(n, float(i))


def poisoned(i, at):
    v = qrow(i)
    v[at] = np.nan
    return v


def _run(sl, script, policy, *, executor=None, delays=None):
    """One loop under a VirtualClock; returns what the tests compare."""
    ex = executor or FakeExecutor(sl)
    if delays is not None:
        ex = sl.DelayedExecutor(ex, delays)
    done = []
    loop = sl.ServeLoop(sl.ScriptedArrivals(script), ex,
                        policy=sl.ServePolicy(**policy),
                        clock=sl.VirtualClock(),
                        on_complete=lambda t: done.append(t.qid))
    rep = loop.run()
    return {
        "trace": [dataclasses.astuple(r) for r in rep.trace],
        "tickets": [(t.qid, t.t_arrive, t.t_admit, t.t_dispatch,
                     t.t_complete, t.batch_id, t.error, t.converged,
                     t.stalled) for t in rep.tickets],
        "results": [None if t.result is None else t.result.tolist()
                    for t in rep.tickets],
        "done": done,
        "latencies": rep.latencies_s,
        "wall": rep.wall_time_s,
        "summary": rep.summary(),
    }


def _eager(count):
    return [(0.0, qrow(i)) for i in range(count)]


SCENARIOS = {
    "fill": lambda sl: _run(sl, _eager(8), dict(b_max=4, deadline_s=1.0,
                                                queue_cap=8)),
    "deadline": lambda sl: _run(
        sl, [(0.0, qrow(0)), (0.0, qrow(1)), (0.0, qrow(2)),
             (10.0, qrow(3))], dict(b_max=4, deadline_s=0.5, queue_cap=8)),
    "drain": lambda sl: _run(sl, _eager(3), dict(b_max=8, deadline_s=100.0,
                                                 queue_cap=8)),
    "backpressure": lambda sl: _run(
        sl, _eager(12), dict(b_max=4, deadline_s=math.inf, queue_cap=4,
                             max_in_flight=1),
        delays=lambda n_live, bid: 1.0),
    "out_of_order": lambda sl: _run(
        sl, _eager(4), dict(b_max=2, deadline_s=math.inf, queue_cap=8,
                            max_in_flight=2),
        delays=lambda n_live, bid: {0: 2.0, 1: 0.5}[bid]),
    "replay": lambda sl: [_run(
        sl, [(i * 0.01, qrow(i)) for i in range(11)],
        dict(b_max=4, deadline_s=0.05, queue_cap=6, max_in_flight=2),
        delays=lambda n_live, bid: 0.03 + 0.01 * (bid % 2))
        for _ in range(2)],
    "poison_at_admission": lambda sl: _run(
        sl, [(0.0, qrow(0)), (0.0, poisoned(1, 2)), (0.0, qrow(2))],
        dict(b_max=4, queue_cap=8)),
    "poison_isolate": lambda sl: _run(
        sl, [(0.0, qrow(0)), (0.0, qrow(1)), (0.0, poisoned(2, 1)),
             (0.0, qrow(3))],
        dict(b_max=4, queue_cap=8, validate_admission=False),
        executor=FakeExecutor(sl, fail_on_nan=True)),
    "unconverged": lambda sl: _run(
        sl, _eager(3), dict(b_max=4, queue_cap=8),
        executor=FakeExecutor(sl, unconverged_mark=1.0)),
    "latency_summary": lambda sl: _run(
        sl, _eager(3), dict(b_max=1, pad="none", queue_cap=8,
                            max_in_flight=3),
        delays=lambda n_live, bid: [0.1, 0.2, 0.4][bid]),
}


def _same(a, b):
    """Equal, with NaN equal to NaN (a summary of no latencies has NaN
    percentiles)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduler_matches_reference(scenario):
    ref, port = (SCENARIOS[scenario](sl) for sl in MODULES.values())
    assert _same(port, ref), (scenario, port, ref)
    if scenario == "replay":         # the same script, the same bits
        assert _same(port[0], port[1])
    if scenario == "poison_isolate":
        assert [t[0] for t in port["trace"]] == list(range(5))
        assert [t[1] for t in port["trace"]] == ["fill"] + ["isolate"] * 4
    if scenario == "latency_summary":
        assert port["summary"]["p50_latency_s"] == pytest.approx(0.2)
        assert port["summary"]["p99_latency_s"] == pytest.approx(0.396)


REFUSALS = {
    "clock_backwards": lambda sl: sl.VirtualClock(2.0).advance_to(1.0),
    "arrivals_out_of_order": lambda sl: sl.ScriptedArrivals(
        [(1.0, qrow(0)), (0.5, qrow(1))]),
    "not_arrived": lambda sl: sl.ScriptedArrivals([(2.0, qrow(1))]).pop(1.0),
    "queue_cap": lambda sl: sl.ServePolicy(b_max=8, queue_cap=4),
    "pad": lambda sl: sl.ServePolicy(pad="mirror"),
    "b_max": lambda sl: sl.ServePolicy(b_max=0),
    "max_in_flight": lambda sl: sl.ServePolicy(max_in_flight=0),
    "deadline": lambda sl: sl.ServePolicy(deadline_s=-1.0),
    "percentile_q": lambda sl: sl.percentile([1.0], 101.0),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_reference(case):
    errors = []
    for sl in MODULES.values():
        with pytest.raises(Exception) as e:
            REFUSALS[case](sl)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_padded_sizes_match_reference():
    for pad in ("pow2", "full", "none"):
        sizes = [[sl.ServePolicy(b_max=16, pad=pad).padded_size(k)
                  for k in range(1, 17)] for sl in MODULES.values()]
        assert sizes[0] == sizes[1]
    assert [tsl.ServePolicy(b_max=16).padded_size(k)
            for k in (1, 2, 3, 5, 9, 16)] == [1, 2, 4, 8, 16, 16]


def test_percentile_is_numpys():
    r = np.random.default_rng(3)
    vals = r.uniform(0, 10, 37).tolist()
    for q in (0.0, 12.5, 50.0, 90.0, 99.0, 100.0):
        got = tsl.percentile(vals, q)
        assert got == pytest.approx(float(np.percentile(vals, q)),
                                    rel=1e-12)
        assert got == jsl.percentile(vals, q)
    assert tsl.percentile([0.1, 0.2, 0.4], 99.0) == pytest.approx(0.396)
    assert math.isnan(tsl.percentile([], 50.0))


def test_merge_bench_section_writes_the_references_layout(tmp_path):
    rows = [{"mode": "fixed", "queries_per_sec": 1.5}]
    for name, sl in MODULES.items():
        path = tmp_path / f"{name}.json"
        sl.merge_bench_section(str(path), "bench_serve", {"n": 3}, rows)
        sl.merge_bench_section(str(path), "other", {}, [])
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "reference.json").read_text()


# ---------------------------------------------------------------------------
# real sessions
# ---------------------------------------------------------------------------

def _stream(count, seed=0):
    st = QueryStream(n=N, p=P, batch=8, nnz=10, seed=seed)
    return st.dictionary(np.float32), list(st.queries(count,
                                                      dtype=np.float32))


def _port_session(X, **solve):
    return LassoSession.fit(X, device="cpu", config=PathConfig(
        solve=SolveSpec(**{"tol": TOL, **solve})))


def _serve(sl, sess, ys, b_max=4, **policy):
    ex = sl.SessionExecutor(sess, num_lambdas=K, hi_frac=0.95)
    loop = sl.ServeLoop(sl.ScriptedArrivals([(0.0, y) for y in ys]), ex,
                        policy=sl.ServePolicy(b_max=b_max, queue_cap=8,
                                              **policy),
                        clock=sl.VirtualClock())
    return loop.run()


@pytest.mark.parametrize("count, trace", [
    (8, [("fill", 4, 4), ("fill", 4, 4)]),
    (7, [("fill", 4, 4), ("drain", 3, 4)]),
    (5, [("fill", 4, 4), ("drain", 1, 1)]),
])
def test_served_masks_bit_identical_to_direct_port_session(count, trace):
    """Fill batches, a pow-2-padded drain (3 live queries, the last one
    repeated into the padded lane) and a 1-live drain (the session's
    single-query driver): every served mask equals the direct call's."""
    X, ys = _stream(count)
    sess = _port_session(X)
    rep = _serve(tsl, sess, ys)
    assert [(r.reason, r.n_live, r.padded_b) for r in rep.trace] == trace
    assert rep.summary()["n_ok"] == count
    for t in rep.tickets:
        direct = sess.path(ys[t.qid], t.result.lambdas)
        np.testing.assert_array_equal(direct.masks[0], t.result.masks)
        err = float(np.abs(direct.betas[0] - t.result.betas).max())
        assert err <= beta_err_tol(ys[t.qid], TOL), (t.qid, err)


def _reference_scores(X, y, lambdas, betas):
    """EDPP scores at each step of a reference path, from its own β (the
    sequential state each step was screened from)."""
    col_norms = np.sqrt((X.astype(np.float64) ** 2).sum(0))
    eng = JEngine(jnp.asarray(X), jnp.asarray(y), backend="jnp")
    state = eng.state_at_lambda_max()
    out = {}
    for k, lam in enumerate(lambdas):
        if lam >= eng.lam_max:
            continue
        sp = jscr.SPHERE_RULES["edpp"](jnp.asarray(y), lam, state)
        out[k] = (np.abs(X.T.astype(np.float64) @ np.asarray(sp.centre))
                  + float(sp.rho) * col_norms)
        beta = betas[k].astype(np.float32)
        state = eng.make_state(jnp.asarray(beta), lam,
                               fitted=jnp.asarray(X @ beta))
    return out


def test_serve_matches_reference_serve_loop():
    """The same stream through both packages' loops, each over its own
    session: the same trace; masks equal outside the band; β within
    beta_err_tol."""
    X, ys = _stream(11, seed=1)
    ref = _serve(jsl, JSession.fit(jnp.asarray(X), config=JConfig(
        solve=JSolve(tol=TOL))), ys)
    port = _serve(tsl, _port_session(X), ys)
    assert [dataclasses.astuple(r) for r in port.trace] \
        == [dataclasses.astuple(r) for r in ref.trace]
    assert [(r.reason, r.n_live, r.padded_b) for r in port.trace] \
        == [("fill", 4, 4), ("fill", 4, 4), ("drain", 3, 4)]
    band_cols = 0
    for t_p, t_j in zip(port.tickets, ref.tickets):
        assert t_p.ok and t_j.ok and t_p.converged == t_j.converged
        lam_j = np.asarray(t_j.result.lambdas)
        np.testing.assert_allclose(t_p.result.lambdas, lam_j, rtol=2 ** -20)
        masks_j = np.asarray(t_j.result.masks)
        scores = _reference_scores(X, ys[t_j.qid], lam_j,
                                   np.asarray(t_j.result.betas))
        for k in range(K):
            diff = t_p.result.masks[k] != masks_j[k]
            band = np.abs(scores[k] - (1.0 - 1e-6)) <= BAND if k in scores \
                else np.zeros_like(diff)
            band_cols += int(band.sum())
            assert not (diff & ~band).any(), (t_p.qid, k)
        err = float(np.abs(t_p.result.betas
                           - np.asarray(t_j.result.betas)).max())
        assert err <= beta_err_tol(ys[t_p.qid], TOL), (t_p.qid, err)
    print(f"{band_cols} query-step-columns in the band")


def test_nan_query_isolated_as_the_reference_does():
    """A NaN query inside a real batch: the path driver refuses the batch,
    the loop re-serves each query alone, only the NaN's ticket fails, and
    its neighbours' masks equal the direct calls' bit for bit."""
    X, ys = _stream(4, seed=2)
    ys[2] = ys[2].copy()
    ys[2][0] = np.nan
    sess = _port_session(X)
    rep = _serve(tsl, sess, ys, validate_admission=False)
    ref = _serve(jsl, JSession.fit(jnp.asarray(X), config=JConfig(
        solve=JSolve(tol=TOL))), ys, validate_admission=False)
    assert [r.reason for r in rep.trace] \
        == [r.reason for r in ref.trace] \
        == ["fill", "isolate", "isolate", "isolate", "isolate"]
    s = rep.summary()
    assert s["n_ok"] == 3 and s["n_errors"] == 1
    assert rep.tickets[2].error.startswith("ValueError")
    for qid in (0, 1, 3):
        t = rep.tickets[qid]
        direct = sess.path(ys[qid], t.result.lambdas)
        np.testing.assert_array_equal(direct.masks[0], t.result.masks)


def test_unconverged_queries_flagged_on_their_tickets():
    X, ys = _stream(3, seed=3)
    rep = _serve(tsl, _port_session(X, tol=1e-10, max_iter=2), ys)
    s = rep.summary()
    assert s["n_errors"] == 0 and s["n_unconverged"] == 3
    assert all(t.converged is False for t in rep.tickets)


@pytest.mark.parametrize("batched", [False, True])
def test_nan_query_refused_by_both_packages(batched):
    """The reference asserts its λ grid decreases, and a NaN λ_max makes
    a NaN grid; the port refuses it with ValueError (before the repair its
    single query returned a finite β, its batch a non-finite one)."""
    st = QueryStream(n=20, p=60, batch=4, nnz=5, seed=0)
    X = st.dictionary(np.float32)
    Y = st.host_batch(0)["y"].astype(np.float32)
    Y[2, 0] = np.nan
    query = Y if batched else Y[2]
    kw = dict(num_lambdas=4, hi_frac=0.95)
    with pytest.raises(AssertionError, match="decreasing"):
        JSession.fit(jnp.asarray(X)).path(jnp.asarray(query), **kw)
    with pytest.raises(ValueError, match="decreasing"):
        LassoSession.fit(X, device="cpu").path(query, **kw)


def test_path_result_totals_are_the_sums_of_the_stats():
    X, ys = _stream(2, seed=4)
    res_t = _port_session(X).path(np.stack(ys), num_lambdas=K)
    res_j = JSession.fit(jnp.asarray(X)).path(jnp.asarray(ys[0]),
                                              num_lambdas=K)
    for res in (res_t, res_j, res_t.query(1)):
        assert res.total_solve_time == sum(s.solve_time_s
                                           for s in res.stats)
        assert res.total_screen_time == sum(s.screen_time_s
                                            for s in res.stats)
    assert res_t.total_solve_time > 0 and res_t.total_screen_time > 0
