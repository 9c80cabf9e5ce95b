"""Fleet autoscaling and overload survival in both packages (the ports of
``tests/test_autoscale.py`` and ``tests/test_overload.py``).

* ledger and runtime — the port's copies bill, retire, drain, keep alive,
  retry and back off exactly as the reference's on the virtual clock;
* scatter — mutable replica groups and aware routing;
* controller — the port's ``FleetController`` (``AutoscalePolicy`` with
  ``exec_scale``, per-partition bounds and targets) takes the reference's
  decisions at the reference's instants: every scale event, response,
  runtime record and ledger line is equal, and results stay bit-identical
  to an unscaled fleet and the oracle throughout;
* overload — bounded retries with typed exhaustion (503) and the
  scatter's degraded merge.
"""

import pytest
import torch

from repro.data.corpus import synth_corpus, synth_queries
from torch_pairs import J, PACKAGES, T, same_response, same_runtime

K = 10
N_PARTS = 2
GB2 = 2 << 30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    return synth_corpus(240, vocab=400, seed=41)


@pytest.fixture(scope="module")
def queries(corpus):
    return synth_queries(corpus, 40, seed=43)


def _build(P, corpus, **kw):
    kw.setdefault("search_config", P.SearchConfig(sim_exec_s=0.002))
    kw.setdefault("n_parts", N_PARTS)
    return P.build(corpus, **kw)


def _policy(P, **kw):
    for key, v in dict(min_replicas=1, max_replicas=2, tick_s=0.25, rate_window_s=1.0,
                       up_qps_per_replica=5.0, down_qps_per_replica=1.0,
                       idle_ticks_to_retire=2).items():
        kw.setdefault(key, v)
    return P.AutoscalePolicy(**kw)


def _drive(app, qs, gap):
    out = []
    for q in qs:
        r = app.query(q, k=K, t_arrival=app.runtime.clock + gap, fetch_docs=False)
        assert r.ok, r.body
        out.append(r)
    return out


def both(scenario):
    """``scenario(P) -> (app, responses)`` in both packages: responses,
    records, ledger and the controller's events equal the reference's."""
    (j, jr), (t, tr) = (scenario(P) for P in PACKAGES)
    assert len(tr) == len(jr)
    for got, want in zip(tr, jr):
        same_response(got, want)
    same_runtime(t, j)
    if j.controller is not None:
        assert t.controller.events == j.controller.events
        assert t.controller.replica_counts() == j.controller.replica_counts()
    return t, j


# -- ledger layer -------------------------------------------------------------


def _ledger_case(P):
    led = P.CostLedger()
    for _ in range(10):
        led.charge(P.Invocation(GB2, 0.1))
    for _ in range(3):
        led.charge(P.Invocation(GB2, 0.1, hedge=True))
    return led


def test_dollars_per_1k_counts_logical_queries_under_hedging():
    t, j = _ledger_case(T), _ledger_case(J)
    assert t.invocations == 13 and t.dollars_per_1k(10) == j.dollars_per_1k(10)
    assert t.dollars_per_1k(10) == pytest.approx(t.total_dollars / 10 * 1000.0)
    assert t.hedge_dollars == j.hedge_dollars > 0
    assert t.dollars_per_1k(0) != t.dollars_per_1k(0)


def test_empty_ledger_reports_zero_not_an_error():
    for P in PACKAGES:
        led = P.CostLedger()
        assert led.dollars_per_1k(0) == 0.0 and led.total_dollars == 0.0
        att = led.attribution()
        assert set(att) == {"serving", "hedge", "idle", "write", "backfill"}
        assert all(v == 0.0 for v in att.values())
        assert led.queries_per_dollar() == float("inf")
        led.charge(P.Invocation(GB2, 0.05, idle=True))
        assert led.dollars_per_1k(0) != led.dollars_per_1k(0) and led.dollars_per_1k(10) > 0


def test_attribution_partitions_the_compute_bill():
    att = []
    for P in PACKAGES:
        led = P.CostLedger()
        led.charge(P.Invocation(GB2, 0.2))
        led.charge(P.Invocation(GB2, 0.2, hedge=True))
        led.charge(P.Invocation(GB2, 0.05, idle=True))
        assert sum(led.attribution().values()) == pytest.approx(led.compute_dollars)
        att.append(led.attribution())
    assert att[0] == att[1]


# -- runtime layer ------------------------------------------------------------


def _sleepy_handler(cache, payload):
    cache.get_or_hydrate("state", "v1", lambda: (object(), 0.2))
    return payload, 0.01


def test_keepalive_bills_idle_and_stays_out_of_percentiles():
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig())
        rt.register("f", _sleepy_handler)
        _, rec = rt.invoke("f", 0, keepalive=True)
        assert rec.keepalive and rt.ledger.idle_invocations == 1
        p = rt.latency_percentiles("f", qs=(0.5,))
        assert p[0.5] != p[0.5]
        _, rec2 = rt.invoke("f", 1, t_arrival=rt.clock + 1)
        assert rt.ledger.idle_invocations == 1
        assert rt.latency_percentiles("f", qs=(0.5,))[0.5] == pytest.approx(rec2.latency_s)


def test_hedge_policy_ignores_keepalive_history():
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig())
        rt.register("p", _sleepy_handler)
        rt.register("r", _sleepy_handler)
        pol = P.HedgePolicy(min_history=2)
        for i in range(4):
            rt.invoke("p", i, t_arrival=rt.clock + 1, keepalive=True)
        assert pol.threshold_s(rt, ["p", "r"]) is None
        for i in range(2):
            rt.invoke("p", i, t_arrival=rt.clock + 1)
        assert pol.threshold_s(rt, ["p", "r"]) is not None


def test_retire_blocks_new_invocations_and_drains():
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig())
        rt.register("f", _sleepy_handler)
        rt.register("g", _sleepy_handler)
        _, rec = rt.invoke("f", 0)
        rt.retire("f", t=rec.t_done - 0.05)
        assert not rt.registered("f") and rt.fleet_size == 1
        with pytest.raises(P.RuntimeError_, match="retired"):
            rt.invoke("f", 1, t_arrival=rec.t_done + 1)
        rt.invoke("g", 0, t_arrival=rec.t_done + 1)
        assert all(i.fn != "f" for i in rt._instances)
        rt.retire("g", t=rt.clock + 1)
        assert rt.fleet_size == 0
        rt.register("g", _sleepy_handler)
        rt.invoke("g", 0, t_arrival=rt.clock + 2)


def test_pool_introspection():
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig(idle_timeout_s=100.0))
        rt.register("f", _sleepy_handler)
        assert rt.pool_expiry_s("f") is None
        _, rec = rt.invoke("f", 0)
        assert rt.pool_busy("f", rec.t_done - 0.01) and not rt.pool_busy("f", rec.t_done + 0.01)
        assert rt.pool_expiry_s("f", rec.t_done + 10.0) == pytest.approx(90.0)
        assert rt.kill_instance(fn="f")
        assert rt.recent_kills("f", now=rt.clock, window_s=30.0) == 1
        assert rt.recent_kills("f", now=rt.clock + 60.0, window_s=30.0) == 0


def test_pool_expiry_boundary_semantics():
    for P in PACKAGES:
        cfg = P.RuntimeConfig(idle_timeout_s=100.0)
        rt = P.FaaSRuntime(cfg)
        rt.register("f", _sleepy_handler)
        _, rec = rt.invoke("f", 0)
        t_exact = rec.t_done + cfg.idle_timeout_s
        assert rt.pool_expiry_s("f", t_exact) == pytest.approx(0.0)
        assert rt.probe("f", t_exact) == (0.0, 0.0)
        eps = 1e-6
        assert rt.probe("f", t_exact + eps) == (0.0, cfg.provision_s)
        _, rec2 = rt.invoke("f", 1, t_arrival=t_exact)
        assert not rec2.cold and rec2.instance_id == rec.instance_id


def test_latency_percentile_window_tracks_regime_shift():
    got = []
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig())
        rt.register("f", lambda cache, payload: (payload, payload))
        t = 0.0
        for exec_s, n in ((0.01, 400), (0.1, 200)):
            for _ in range(n):
                t += 1.0
                rt.invoke("f", exec_s, t_arrival=t)
        windowed = rt.latency_percentiles("f", qs=(0.5,), warm_only=True, window=256)[0.5]
        assert windowed == pytest.approx(0.1)
        pol = P.HedgePolicy(percentile=0.5, scale=2.0, min_history=4, window=256)
        sc = P.ScatterGather(rt, [["f"]])
        ctl = P.FleetController(rt, sc, [lambda: _sleepy_handler],
                                P.AutoscalePolicy(warm_window=256))
        got.append((windowed, pol.threshold_s(rt, ["f"]), ctl._overhead_threshold(["f"]),
                    len(rt.recent_latencies("f", window=256))))
    assert got[0] == got[1]


# -- scatter layer ------------------------------------------------------------


def test_replica_groups_are_mutable_with_last_replica_guard():
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig())
        for fn in ("a", "a1", "b"):
            rt.register(fn, _sleepy_handler)
        sc = P.ScatterGather(rt, [["a"], ["b"]])
        sc.add_replica(0, "a1")
        assert sc.groups[0] == ["a", "a1"]
        with pytest.raises(ValueError):
            sc.add_replica(0, "a1")
        sc.remove_replica(0, "a1")
        with pytest.raises(ValueError):
            sc.remove_replica(0, "a")
        with pytest.raises(ValueError):
            sc.remove_replica(1, "a")


@pytest.mark.parametrize("routing", ["static", "aware"])
def test_aware_routing_rotates_primary_off_killed_pool(corpus, queries, routing):
    def scenario(P):
        app = _build(P, corpus, replicas=2, routing=routing)
        app.warm()
        out = [app.query(queries[0], k=K, t_arrival=app.runtime.clock + 0.5,
                         fetch_docs=False)]
        assert app.runtime.kill_instance(fn=app.fn_names[0])
        n0 = len(app.runtime.records)
        out.append(app.query(queries[1], k=K, t_arrival=app.runtime.clock + 0.5,
                             fetch_docs=False))
        rec0 = next(r for r in app.runtime.records[n0:] if r.fn in app.fn_groups[0])
        assert (rec0.fn == app.fn_groups[0][1]) == (routing == "aware")
        assert rec0.cold == (routing == "static")
        return app, out

    both(scenario)


# -- controller layer ---------------------------------------------------------


def test_controller_scales_up_on_burst_and_down_when_idle(corpus, queries):
    def scenario(P):
        app = _build(P, corpus, replicas=1, hedge=P.HedgePolicy(), autoscale=_policy(P))
        assert app.scatter.routing == "aware"
        app.warm()
        out = _drive(app, queries[:12], gap=0.04)
        assert app.controller.replica_counts() == [2] * N_PARTS
        assert app.fn_groups[0][1] == "search-p0r1"
        assert app.runtime.registered("search-p0r1")
        out += _drive(app, queries[12:18], gap=60.0)
        assert app.controller.replica_counts() == [1] * N_PARTS
        assert not app.runtime.registered("search-p0r1")
        return app, out

    both(scenario)


def test_retiring_idle_replica_strictly_cuts_cost(corpus, queries):
    def run(P, policy):
        app = _build(P, corpus, replicas=2, hedge=P.HedgePolicy(), autoscale=policy,
                     runtime_config=P.RuntimeConfig(idle_timeout_s=60.0))
        app.warm()
        out = _drive(app, queries[:4], gap=0.5)
        led = app.runtime.ledger
        d0, idle0 = led.total_dollars, led.idle_dollars
        tick = app.runtime.clock
        for q in queries[4:8]:
            t_arr = app.runtime.clock + 600.0
            while tick + 15.0 < t_arr:
                tick += 15.0
                app.controller.maybe_tick(tick)
            tick = max(tick, t_arr)
            out.append(app.query(q, k=K, t_arrival=t_arr, fetch_docs=False))
        app._spend = (led.total_dollars - d0, led.idle_dollars - idle0)
        return app, out

    fixed, _ = both(lambda P: run(P, _policy(P, min_replicas=2, max_replicas=2)))
    auto, _ = both(lambda P: run(P, _policy(P)))
    assert fixed.controller.replica_counts() == [2] * N_PARTS
    assert auto.controller.replica_counts() == [1] * N_PARTS
    assert auto._spend[1] < fixed._spend[1] and auto._spend[0] < fixed._spend[0]


def _skewed(P, **policy):
    corpus = synth_corpus(350, vocab=400, seed=45)
    return P.build(
        corpus, n_parts=2, replicas=1, hedge=P.HedgePolicy(),
        autoscale=P.AutoscalePolicy(
            min_replicas=1, max_replicas=3, tick_s=0.25, rate_window_s=1.0,
            up_qps_per_replica=float("inf"), down_qps_per_replica=1.0,
            idle_ticks_to_retire=2, target_utilization=0.6, **policy),
        partition_weights=[6.0, 1.0],
        runtime_config=P.RuntimeConfig(idle_timeout_s=60.0),
        search_config=P.SearchConfig(sim_exec_s=0.002, sim_exec_per_kdoc_s=0.4))


def test_heterogeneous_targets_scale_head_not_tail():
    queries = synth_queries(synth_corpus(350, vocab=400, seed=45), 60, seed=46)

    def scenario(P):
        app = _skewed(P)
        app.warm()
        t0 = app.runtime.clock + 1.0
        out = [app.query(q, k=K, t_arrival=t0 + (1 / 6) * i, fetch_docs=False)
               for i, q in enumerate(queries[:40])]
        assert app.controller.replica_counts() == [2, 1]
        assert app.controller.replica_targets() == [2, 1]
        t = tick = t0 + (1 / 6) * 40
        for q in queries[40:46]:
            t += 120.0
            while tick + 15.0 < t:
                tick += 15.0
                app.controller.maybe_tick(tick)
            out.append(app.query(q, k=K, t_arrival=t, fetch_docs=False))
        assert app.controller.replica_counts() == [1, 1]
        return app, out

    both(scenario)


@pytest.mark.parametrize("exec_scale,counts", [(1.0, [2, 1]), (0.02, [1, 1]),
                                               ([1.0, 0.02], [2, 1])])
def test_exec_scale_feeds_b9b_fraction_into_concurrency_rule(exec_scale, counts):
    queries = synth_queries(synth_corpus(350, vocab=400, seed=45), 40, seed=46)

    def scenario(P):
        app = _skewed(P, exec_scale=exec_scale)
        app.warm()
        t0 = app.runtime.clock + 1.0
        out = [app.query(q, k=K, t_arrival=t0 + (1 / 6) * i, fetch_docs=False)
               for i, q in enumerate(queries)]
        assert app.controller.replica_counts() == counts
        with pytest.raises(ValueError, match="per-partition exec_scale"):
            P.FleetController(app.runtime, app.scatter, [lambda: _sleepy_handler] * 2,
                              P.AutoscalePolicy(exec_scale=[1.0, 0.5, 0.2]))
        return app, out

    both(scenario)


def test_over_provisioned_group_drains_under_live_traffic():
    corpus = synth_corpus(240, vocab=400, seed=47)
    queries = synth_queries(corpus, 30, seed=48)

    def scenario(P):
        app = P.build(
            corpus, n_parts=2, replicas=2, hedge=P.HedgePolicy(),
            autoscale=P.AutoscalePolicy(
                min_replicas=1, max_replicas=3, tick_s=0.25, rate_window_s=1.0,
                up_qps_per_replica=float("inf"), down_qps_per_replica=1.0,
                idle_ticks_to_retire=2, target_utilization=0.6),
            runtime_config=P.RuntimeConfig(idle_timeout_s=60.0),
            search_config=P.SearchConfig(sim_exec_s=0.002))
        app.warm()
        t0 = app.runtime.clock + 1.0
        out = [app.query(q, k=K, t_arrival=t0 + 0.2 * i, fetch_docs=False)
               for i, q in enumerate(queries)]
        assert app.controller.replica_counts() == [1, 1]
        downs = [e for e in app.controller.events if e["action"] == "retire"]
        assert downs and all("over-provisioned" in e["reason"] for e in downs)
        return app, out

    both(scenario)


def test_per_partition_replica_bounds():
    corpus = synth_corpus(240, vocab=400, seed=49)
    queries = synth_queries(corpus, 20, seed=50)

    def scenario(P):
        app = P.build(
            corpus, n_parts=2, replicas=2, hedge=P.HedgePolicy(),
            autoscale=P.AutoscalePolicy(
                min_replicas=[2, 1], max_replicas=[3, 1], tick_s=0.25,
                rate_window_s=1.0, up_qps_per_replica=float("inf"),
                down_qps_per_replica=1.0, idle_ticks_to_retire=2,
                target_utilization=0.6),
            runtime_config=P.RuntimeConfig(idle_timeout_s=60.0),
            search_config=P.SearchConfig(sim_exec_s=0.002))
        app.warm()
        t0 = app.runtime.clock + 1.0
        out = [app.query(q, k=K, t_arrival=t0 + 0.2 * i, fetch_docs=False)
               for i, q in enumerate(queries)]
        assert app.controller.replica_counts() == [2, 1]
        with pytest.raises(ValueError, match="per-partition replica bounds"):
            P.FleetController(app.runtime, app.scatter, [lambda: _sleepy_handler] * 2,
                              P.AutoscalePolicy(min_replicas=[1, 1, 1]))
        return app, out

    both(scenario)


def test_results_bit_identical_through_scale_events(corpus, queries):
    def run(app):
        app.warm()
        out = []
        for i, q in enumerate(queries[:16]):
            if i == 12:
                app.runtime.kill_instance(fn=app.fn_names[0])
            out.append(app.query(q, k=K, t_arrival=app.runtime.clock + 0.04,
                                 fetch_docs=False))
        return out + [app.query(q, k=K, t_arrival=app.runtime.clock + 60.0,
                                fetch_docs=False) for q in queries[16:22]]

    def scenario(P):
        app = _build(P, corpus, replicas=1, hedge=P.HedgePolicy(), autoscale=_policy(P))
        app._out = run(app)
        return app, app._out

    auto, _ = both(scenario)
    assert auto.controller.events
    plain = run(_build(T, corpus, replicas=1))
    oracle = T.OracleSearcher(corpus)
    for p, r, q in zip(plain, auto._out, queries[:22], strict=True):
        assert (r.body["ids"], r.body["scores"]) == (p.body["ids"], p.body["scores"])
        assert r.body["ids"] == [d for d, _ in oracle.search(q, k=K)], q


def test_autoscale_policy_through_replication_spec_and_legacy_kwarg(corpus, queries):
    """``ReplicationSpec(autoscale=True)`` attaches the default controller,
    and the deprecated ``autoscale=`` keyword builds the same fleet."""
    spec = T.build(corpus, T.FleetSpec(
        n_parts=N_PARTS, replication=T.ReplicationSpec(autoscale=True),
        search_config=T.SearchConfig(sim_exec_s=0.002)))
    with pytest.warns(DeprecationWarning):
        legacy = _build(T, corpus, autoscale=True)
    for app in (spec, legacy):
        assert app.controller is not None and app.scatter.routing == "aware"
        assert app.controller.policy == T.AutoscalePolicy()
    a, b = (_drive(app, queries[:6], gap=0.04) for app in (spec, legacy))
    for x, y in zip(a, b):
        same_response(x, y)
    assert spec.controller.events == legacy.controller.events


# -- overload: RetryPolicy, typed exhaustion, degraded merges ----------------------


class _ScriptedRng:
    def __init__(self, draws):
        self.draws = list(draws)

    def random(self):
        return self.draws.pop(0)


class _NoDrawRng:
    def random(self):
        raise AssertionError("jitter must not draw when backoff is zero")


def test_retry_policy_validation():
    for P in PACKAGES:
        for bad in (dict(max_attempts=0), dict(base_backoff_s=-1.0),
                    dict(max_backoff_s=-0.1), dict(multiplier=0.5), dict(jitter=1.5)):
            with pytest.raises(ValueError):
                P.RetryPolicy(**bad)


def test_retry_policy_backoff_schedule_and_cap():
    for P in PACKAGES:
        pol = P.RetryPolicy(max_attempts=4, base_backoff_s=0.1, multiplier=2.0,
                            max_backoff_s=0.35, jitter=0.0)
        assert [pol.backoff_s(i, _NoDrawRng()) for i in (1, 2, 3)] == \
            pytest.approx([0.1, 0.2, 0.35])


def test_zero_backoff_never_draws_jitter():
    for P in PACKAGES:
        assert P.RetryPolicy(jitter=0.5).backoff_s(1, _NoDrawRng()) == 0.0


def test_legacy_max_retries_maps_onto_policy():
    for P in PACKAGES:
        assert P.RuntimeConfig(max_retries=4).retry_policy().max_attempts == 5
        explicit = P.RetryPolicy(max_attempts=2)
        assert P.RuntimeConfig(max_retries=9, retry=explicit).retry_policy() is explicit


def test_retries_exhaust_typed_and_backoff_on_virtual_clock():
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig(
            failure_rate=1.0, seed=1, retry=P.RetryPolicy(
                max_attempts=3, base_backoff_s=0.1, multiplier=2.0,
                max_backoff_s=0.15, jitter=0.0)))
        rt.register("f", lambda cache, p: (p, 0.001))
        with pytest.raises(P.RetriesExhausted) as ei:
            rt.invoke("f", {}, t_arrival=0.0)
        assert ei.value.fn == "f" and ei.value.attempts == 3
        assert isinstance(ei.value, P.RuntimeError_)
        assert rt.clock == pytest.approx(0.25) and rt.ledger.invocations == 0


def test_jittered_backoff_reproducible_per_seed():
    def run(P, seed):
        rt = P.FaaSRuntime(P.RuntimeConfig(failure_rate=1.0, seed=seed, retry=P.RetryPolicy(
            max_attempts=4, base_backoff_s=0.1, jitter=0.5)))
        rt.register("f", lambda cache, p: (p, 0.001))
        with pytest.raises(P.RetriesExhausted):
            rt.invoke("f", {}, t_arrival=0.0)
        return rt.clock

    assert run(T, 7) == run(J, 7) == run(T, 7) != run(T, 8)


def test_gateway_maps_exhaustion_to_503():
    out = []
    for P in PACKAGES:
        rt = P.FaaSRuntime(P.RuntimeConfig(failure_rate=1.0, max_retries=1, seed=3))
        rt.register("f", lambda cache, p: (p, 0.001))
        gw = P.Gateway(rt)
        gw.route("GET", "/x", "f")
        out.append(gw.request("GET", "/x", {}, t_arrival=0.0))
    assert out[1].status == 503 and "died" in out[1].body["error"]
    same_response(out[1], out[0])


@pytest.fixture(scope="module")
def small_corpus():
    return synth_corpus(120, vocab=300, seed=61)


def _fleet(P, corpus, degraded_ok):
    return P.build(corpus, P.FleetSpec(
        n_parts=2, replication=P.ReplicationSpec(replicas=1, degraded_ok=degraded_ok),
        search_config=P.SearchConfig(sim_exec_s=0.002, sim_write_s=0.02)))


def _failing_query(app, q, rate, draws=None):
    app.warm()
    app.runtime.config.failure_rate = rate
    if draws is not None:
        app.runtime._rng = _ScriptedRng(draws)
    r = app.query(q, k=K, t_arrival=app.runtime.clock + 0.05, fetch_docs=False)
    app.runtime.config.failure_rate = 0.0
    return r


def test_degraded_ok_merges_surviving_partitions(small_corpus):
    q = synth_queries(small_corpus, 1, seed=63)[0]

    def scenario(P):
        app = _fleet(P, small_corpus, True)
        r = _failing_query(app, q, 0.5, [0.1, 0.1, 0.1, 0.9])
        assert r.ok and app.scatter.last_degraded == [0]
        p1 = {ext for ext, _ in app.indexer.parts[1].live_docs()}
        assert r.body["ext_ids"] and set(r.body["ext_ids"]) <= p1
        return app, [r]

    both(scenario)


def test_degraded_default_fails_loud_with_503(small_corpus):
    q = synth_queries(small_corpus, 1, seed=63)[0]

    def scenario(P):
        app = _fleet(P, small_corpus, False)
        r = _failing_query(app, q, 0.5, [0.1, 0.1, 0.1])
        assert r.status == 503 and "died" in r.body["error"]
        return app, [r]

    both(scenario)


def test_all_legs_dead_errors_even_when_degraded_ok(small_corpus):
    q = synth_queries(small_corpus, 1, seed=63)[0]

    def scenario(P):
        app = _fleet(P, small_corpus, True)
        r = _failing_query(app, q, 1.0)
        assert r.status == 503
        return app, [r]

    both(scenario)


def test_batched_route_maps_exhaustion_to_503_each(small_corpus):
    q = synth_queries(small_corpus, 1, seed=63)[0]

    def scenario(P):
        app = _fleet(P, small_corpus, False)
        app.warm()
        app.runtime.config.failure_rate = 1.0
        h = app.submit(q, k=K, t_arrival=app.runtime.clock + 30.0, fetch_docs=False)
        app.runtime.config.failure_rate = 0.0
        assert h.done() and h.response.status == 503
        return app, [h.response]

    both(scenario)
