"""The port's simulator against the JAX package's, exactly: makespans,
per-flow start and finish times and port busy times of both the dispatching
`simulate` (the max-plus fast path or the greedy loop) and the
`simulate_reference` event loop, for every schedule of the profile grid;
fault timelines; `simulate_many` in-process and over a pool; and the
opt-in telemetry (stage breakdown, critical path, Chrome trace)."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import obs as jax_obs  # noqa: E402
from repro.core import lower_bounds as jax_lb  # noqa: E402
from repro.core import model as jax_model  # noqa: E402
from repro.core import simulator as jax_sim  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import lower_bounds, model, simulator  # noqa: E402
from test_torch_flow_grid import (PROFILES, assert_arrays_equal,  # noqa: E402
                                  assert_result_equal, assert_tree_equal,
                                  outcome, plan_pair, spec_id,
                                  unique_schedules)


@pytest.mark.parametrize("spec", PROFILES, ids=spec_id)
def test_simulate_equals_jax(spec):
    """Both simulators, both packages, every distinct schedule of the grid;
    within the port, the dispatching path equals the event loop."""
    for want, got in unique_schedules(spec):
        what = (spec, got.algo, got.schedule.meta.get("k"))
        fast = simulator.simulate(got.schedule)
        jax_fast = jax_sim.simulate(want.schedule)
        assert_result_equal(fast, jax_fast, what)
        ref = simulator.simulate_reference(got.schedule)
        # JAX's two simulators agree on every field (its own equivalence
        # tests), so the port's event loop is held to JAX's simulate and,
        # below a few thousand flows, to JAX's event loop as well
        assert_result_equal(ref, jax_fast, what)
        if got.schedule.num_flows < 3000:
            assert_result_equal(
                ref, jax_sim.simulate_reference(want.schedule), what)
        for kind, r, d in ref.port_busy:
            assert fast.utilization(kind, r, d) == \
                ref.utilization(kind, r, d), what


# schedules of each dispatch route, for the timeline, pool and telemetry
# checks: slotted OptCC and the ring (the max-plus fast path), the legacy
# single-straggler construction at p = 3 and 4, multi-straggler and
# multi-GPU OptCC, and the three other topologies (greedy loop)
ROUTES = (("single", (8, 1.5, 3), "optcc", 4),
          ("single", (8, 3.0, 7), "ring", 1),
          ("single", (4, 2.0, 1), "optcc", 4),
          ("multi", (8, (2.0, 1.5)), "optcc", 4),
          ("gpu", (16, 4, None), "optcc", 4),
          ("gpu", (16, 4, 12.0), "hierarchical", 4),
          ("single", (8, 2.0, 4), "dbtree", 4),
          ("single", (8, 1.25, 0), "torus2d", 1))


def _route_pairs():
    for kind, args, name, k in ROUTES:
        want, got = plan_pair((kind, args), name, k, True)
        yield (kind, args, name), want, got


def _timeline(mod, p: int, t: float):
    """A recovery of rank 0, a flap of the last rank and a rank slowed
    twice, at fractions of the run's healthy time t."""
    return mod.FaultTimeline.make([
        (0.0, 0, 2.5), (0.3 * t, 0, 1.0), (0.1 * t, p - 1, 3.0),
        (0.15 * t, p - 1, 1.0), (0.2 * t, 1, 1.5), (0.5 * t, 1, 4.0)])


def test_timeline_runs_equal_jax():
    for what, want, got in _route_pairs():
        js, ts = want.schedule, got.schedule
        t = jax_sim.simulate(js).makespan
        jtl, ttl = _timeline(jax_model, ts.profile.p, t), \
            _timeline(model, ts.profile.p, t)
        assert [dataclasses.astuple(e) for e in ttl.events] == \
            [dataclasses.astuple(e) for e in jtl.events]
        jb, jv = jtl.segments(js.profile)
        tb, tv = ttl.segments(ts.profile)
        assert tb == jb and tv == jv, what
        for t0 in (0.0, 0.12 * t, 0.4 * t):
            assert ttl.after(t0).events == tuple(
                model.FaultEvent(e.t, e.rank, e.ell)
                for e in jtl.after(t0).events)
            assert ttl.slowdown_at(ts.profile, t0) == \
                jtl.slowdown_at(js.profile, t0)
        assert ttl.changes(ts.profile) == jtl.changes(js.profile), what
        assert ttl.is_constant(ts.profile) == jtl.is_constant(js.profile)
        assert ttl.min_profile(ts.profile).slowdown == \
            jtl.min_profile(js.profile).slowdown
        for n in (ts.n, 1 << 20):
            assert outcome(lower_bounds.timeline_lower_bound, ts.profile, ttl,
                         n) == \
                outcome(jax_lb.timeline_lower_bound, js.profile, jtl, n)
        fast = simulator.simulate(ts, timeline=ttl)
        assert_result_equal(fast, jax_sim.simulate(js, timeline=jtl), what)
        ref = simulator.simulate_reference(ts, timeline=ttl)
        assert_result_equal(
            ref, jax_sim.simulate_reference(js, timeline=jtl), what)
        assert fast.makespan == ref.makespan and fast.finish == ref.finish
        # a timeline that never changes the rates is the static run
        const = model.FaultTimeline.make(
            [(0.0, r, l) for r, l in enumerate(ts.profile.slowdown)])
        assert_result_equal(simulator.simulate(ts, timeline=const),
                            simulator.simulate(ts), what)


def test_timeline_rejects_what_jax_rejects():
    for bad in ([(-1.0, 0, 2.0)], [(0.0, -1, 2.0)], [(0.0, 0, 0.5)]):
        with pytest.raises(ValueError) as ours:
            model.FaultTimeline.make(bad)
        with pytest.raises(ValueError) as ref:
            jax_model.FaultTimeline.make(bad)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("workers", [0, 2])
def test_simulate_many_equals_jax(workers):
    pairs = list(_route_pairs())
    got = simulator.simulate_many([g.schedule for _, _, g in pairs],
                                  workers=workers)
    want = jax_sim.simulate_many([w.schedule for _, w, _ in pairs], workers=0)
    assert len(got) == len(want) == len(pairs)
    for (what, _, _), a, b in zip(pairs, got, want):
        assert_result_equal(a, b, what)
    assert simulator.map_scenarios(abs, [-1.5, 2.0, -3.0], workers=workers) \
        == [1.5, 2.0, 3.0]


def test_sim_result_pickles_materialized():
    import pickle
    _, _, got = next(_route_pairs())
    res = simulator.simulate(got.schedule)
    back = pickle.loads(pickle.dumps(res))
    assert_result_equal(back, res)


def test_debug_checks_the_meta_contract(monkeypatch):
    """With REPRO_DEBUG set, simulate refuses a schedule whose meta breaks
    the key contract, as the JAX package's does."""
    _, want, got = next(_route_pairs())
    bad = dataclasses.replace(got.schedule, meta=dict(got.schedule.meta,
                                                      topology=""))
    simulator.simulate(bad)
    monkeypatch.setenv("REPRO_DEBUG", "1")
    with pytest.raises(ValueError, match="topology"):
        simulator.simulate(bad)
    simulator.simulate(got.schedule)


@pytest.mark.parametrize("timeline", [False, True])
def test_telemetry_equals_jax(timeline, tmp_path):
    for what, want, got in _route_pairs():
        js, ts = want.schedule, got.schedule
        jtl = ttl = None
        if timeline:
            t = jax_sim.simulate(js).makespan
            jtl = _timeline(jax_model, ts.profile.p, t)
            ttl = _timeline(model, ts.profile.p, t)
        plain = simulator.simulate(ts, timeline=ttl)
        res = simulator.simulate(ts, telemetry=True, timeline=ttl)
        ref = jax_sim.simulate(js, telemetry=True, timeline=jtl)
        assert plain.telemetry is None
        assert_result_equal(res, plain, what)      # telemetry is post-hoc
        assert_result_equal(res, ref, what)
        tele, jtele = res.telemetry, ref.telemetry
        for field in dataclasses.fields(jtele):
            assert_tree_equal(getattr(tele, field.name), getattr(jtele, field.name),
                       field.name)
        assert_tree_equal(obs.stage_breakdown(tele), jax_obs.stage_breakdown(jtele))
        assert_tree_equal(obs.critical_path(tele), jax_obs.critical_path(jtele))
        assert_tree_equal(obs.chrome_trace(tele, name="x"),
                   jax_obs.chrome_trace(jtele, name="x"))
        assert_tree_equal(obs.port_utilization(tele),
                   jax_obs.port_utilization(jtele))
        assert_tree_equal(obs.port_intervals(tele), jax_obs.port_intervals(jtele))
        assert [obs.stage_name(s) for s in range(-1, 12)] == \
            [jax_obs.stage_name(s) for s in range(-1, 12)]
        ref_ref = simulator.simulate_reference(ts, telemetry=True,
                                               timeline=ttl)
        assert_tree_equal(obs.stage_breakdown(ref_ref.telemetry),
                   obs.stage_breakdown(tele))
        obs.write_chrome_trace(tele, str(tmp_path / "ours.json"))
        jax_obs.write_chrome_trace(jtele, str(tmp_path / "ref.json"))
        assert (tmp_path / "ours.json").read_bytes() == \
            (tmp_path / "ref.json").read_bytes(), what


def test_flow_arrays_of_flow_schedules_equal_jax():
    """FlowArrays.from_schedule over Flow-object schedules of every route."""
    from repro.core.flowvec import FlowArrays as JaxFlowArrays

    from repro_torch.core.flowvec import FlowArrays
    for what, want, got in _route_pairs():
        assert_arrays_equal(FlowArrays.from_schedule(got.schedule),
                            JaxFlowArrays.from_schedule(want.schedule))
