"""`replay` (mid-flight re-planning under a fault timeline) and the fault
detector of the port against the JAX package's, exactly: every
`ReplayResult` field with the oracle controller and with a `DetectorConfig`
under each controller policy, the detector's estimates (seeded
`random.Random` streams), `apply_policy`, `debounce_timeline`,
`estimate_usable`, and `FailureInjector.to_timeline`."""
import dataclasses
import json
import pathlib

import pytest

pytest.importorskip("torch")

from repro import detect as jax_detect  # noqa: E402
from repro.comms import fault as jax_fault  # noqa: E402
from repro.core import lower_bounds as jax_lb  # noqa: E402
from repro.core import model as jax_model  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro_torch import detect  # noqa: E402
from repro_torch.comms import fault  # noqa: E402
from repro_torch.core import lower_bounds, model, planner  # noqa: E402
from test_torch_flow_grid import (assert_plan_equal,  # noqa: E402
                                  assert_result_equal, assert_schedule_equal,
                                  assert_tree_equal, outcome)

P, N, K = 8, 1920, 12
TRACES = sorted((pathlib.Path(__file__).resolve().parent.parent / "ci" /
                 "traces").glob("*.json"))


def _timeline(mod, trace: pathlib.Path):
    """A checked-in trace (times in units of the fault-free optimum, ranks
    modulo p) as one package's FaultTimeline."""
    lb = lower_bounds if mod is model else jax_lb
    scale = lb.t0_fault_free(P, N, 1)
    events = json.loads(trace.read_text())["events"]
    return mod.FaultTimeline.make([(t * scale, int(r) % P, ell)
                                   for t, r, ell in events])


def _events(tl) -> list:
    return [dataclasses.astuple(e) for e in tl.events]


def _detectors(mod, scale: float):
    D = mod.DetectorConfig
    return {"perfect": D.perfect(),
            "default": D.default(scale=scale, seed=0),
            "noisy": D(probe_interval=0.02 * scale, latency=0.05 * scale,
                       noise=0.3, quant=0.25, fp_rate=0.2, fn_rate=0.2,
                       fp_ell=3.0, seed=11)}


def assert_detection_equal(got, want) -> None:
    assert _events(got.timeline) == _events(want.timeline)
    assert dataclasses.astuple(got.config) == dataclasses.astuple(want.config)
    for field in ("probes", "lags", "missed", "false_events", "lag_mean",
                  "lag_max"):
        assert getattr(got, field) == getattr(want, field), field


REPLAY_FIELDS = ("n", "t_noreplan", "t_chain", "replans", "lower_bound",
                 "t0", "policy", "false_replans", "suppressed", "t_replan",
                 "adopted_replan", "detect_lag_mean", "detect_lag_max")


def assert_replay_equal(got, want) -> None:
    for field in REPLAY_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.profile.slowdown == want.profile.slowdown
    assert _events(got.timeline) == _events(want.timeline)
    assert_plan_equal(got.plan0, want.plan0)
    assert_result_equal(got.noreplan_result, want.noreplan_result)
    assert (got.detector is None) == (want.detector is None)
    if want.detector is not None:
        assert dataclasses.astuple(got.detector) == \
            dataclasses.astuple(want.detector)
        assert_detection_equal(got.detection, want.detection)


def _profiles(mod):
    BP = mod.BandwidthProfile
    return {"healthy": BP.healthy(P), "straggler": BP.single_straggler(P, 2.0,
                                                                       5)}


@pytest.mark.parametrize("trace", TRACES, ids=lambda t: t.stem)
def test_replay_oracle_equals_jax(trace):
    for name, prof in _profiles(model).items():
        jprof = _profiles(jax_model)[name]
        for max_replans in (0, 2, 8):
            got = planner.replay(prof, N, _timeline(model, trace), k=K,
                                 max_replans=max_replans)
            want = jax_planner.replay(jprof, N, _timeline(jax_model, trace),
                                      k=K, max_replans=max_replans)
            assert_replay_equal(got, want)
            assert got.policy == "oracle"


@pytest.mark.parametrize("policy", ["immediate", "debounce", "backoff"])
@pytest.mark.parametrize("trace", TRACES, ids=lambda t: t.stem)
def test_replay_with_a_detector_equals_jax(trace, policy):
    assert detect.POLICIES == jax_detect.POLICIES
    assert policy in detect.POLICIES
    scale = jax_lb.t0_fault_free(P, N, 1)
    dets, jdets = _detectors(detect, scale), _detectors(jax_detect, scale)
    ctrls = {"plain": ({"policy": policy}),
             "tuned": ({"policy": policy, "debounce_probes": 2,
                        "backoff_base": 0.05 * scale})}
    for name, prof in _profiles(model).items():
        jprof = _profiles(jax_model)[name]
        for dname, det in dets.items():
            for cname, cargs in ctrls.items():
                if cname == "tuned" and dname != "default":
                    continue
                got = planner.replay(
                    prof, N, _timeline(model, trace), k=K, detector=det,
                    controller=detect.ControllerConfig(**cargs))
                want = jax_planner.replay(
                    jprof, N, _timeline(jax_model, trace), k=K,
                    detector=jdets[dname],
                    controller=jax_detect.ControllerConfig(**cargs))
                assert_replay_equal(got, want)
                assert got.policy == policy


def test_replay_rejects_what_jax_rejects():
    prof, jprof = _profiles(model)["healthy"], _profiles(jax_model)["healthy"]
    tl, jtl = _timeline(model, TRACES[0]), _timeline(jax_model, TRACES[0])
    assert outcome(planner.replay, prof, N, tl, max_replans=-1) == \
        outcome(jax_planner.replay, jprof, N, jtl, max_replans=-1)
    got = outcome(planner.replay, prof, N, tl,
                controller=detect.ControllerConfig())
    assert got == outcome(jax_planner.replay, jprof, N, jtl,
                        controller=jax_detect.ControllerConfig())
    assert got[0] == "raises"


@pytest.mark.parametrize("trace", TRACES, ids=lambda t: t.stem)
def test_detector_estimates_equal_jax(trace):
    scale = jax_lb.t0_fault_free(P, N, 1)
    dets, jdets = _detectors(detect, scale), _detectors(jax_detect, scale)
    for name, prof in _profiles(model).items():
        jprof = _profiles(jax_model)[name]
        tl, jtl = _timeline(model, trace), _timeline(jax_model, trace)
        assert detect.true_changes(prof, tl) == \
            jax_detect.true_changes(jprof, jtl)
        for dname, det in dets.items():
            assert det.is_perfect == jdets[dname].is_perfect
            for horizon in (0.5 * scale, 3.0 * scale):
                got = detect.estimate_timeline(prof, tl, horizon, det)
                want = jax_detect.estimate_timeline(jprof, jtl, horizon,
                                                    jdets[dname])
                assert_detection_equal(got, want)
                for policy in detect.POLICIES:
                    for probes in (1, 2, 3, 5):
                        c = detect.ControllerConfig(policy=policy,
                                                    debounce_probes=probes)
                        jc = jax_detect.ControllerConfig(
                            policy=policy, debounce_probes=probes)
                        a, sa = detect.apply_policy(got, prof, c)
                        b, sb = jax_detect.apply_policy(want, jprof, jc)
                        assert _events(a) == _events(b) and sa == sb
                        for r in range(4):
                            assert c.backoff_spacing(det.probe_interval, r) \
                                == jc.backoff_spacing(det.probe_interval, r)
                for dt in (0.0, det.probe_interval, 0.05 * scale):
                    for probes in (1, 2, 4):
                        a, sa = detect.debounce_timeline(got.timeline, prof,
                                                         dt, probes)
                        b, sb = jax_detect.debounce_timeline(
                            want.timeline, jprof, dt, probes)
                        assert _events(a) == _events(b) and sa == sb


def test_config_checks_equal_jax():
    bad_detectors = ({"probe_interval": -1.0}, {"fp_rate": 1.0,
                                                "probe_interval": 1.0},
                     {"fn_rate": 0.1}, {"noise": -0.1}, {"quant": -1.0})
    for kw in bad_detectors:
        got = outcome(detect.DetectorConfig, **kw)
        want = outcome(jax_detect.DetectorConfig, **kw)
        if isinstance(want, tuple):
            assert got == want, kw
        else:
            assert dataclasses.astuple(got) == dataclasses.astuple(want), kw
    for kw in ({"policy": "never"}, {"debounce_probes": 0}):
        got = outcome(detect.ControllerConfig, **kw)
        assert got == outcome(jax_detect.ControllerConfig, **kw)
        assert got[0] == "raises"
    assert detect.MAX_CREDIBLE_ELL == jax_detect.MAX_CREDIBLE_ELL


@pytest.mark.parametrize("p", [3, 4, 8, 16])
def test_estimate_usable_equals_jax(p):
    ells = (1.0, 1.5, 2.0, detect.MAX_CREDIBLE_ELL,
            detect.MAX_CREDIBLE_ELL + 0.5)
    for m in range(p + 1):
        for ell in ells:
            sl = (ell,) * m + (1.0,) * (p - m)
            got = detect.estimate_usable(model.BandwidthProfile(p, sl))
            want = jax_detect.estimate_usable(
                jax_model.BandwidthProfile(p, sl))
            assert got == want, (p, m, ell)


def test_injector_timeline_equals_jax():
    cases = ((8, 2, 1, 1.5, 4, None), (8, 0, 3, 2.0, None, None),
             (4, 3, 0, 3.0, 9, (0, 1.25)), (16, 1, 15, 1.25, 2, (2, 2.0)))
    for axis, step, straggler, ell, repair, base in cases:
        ours = fault.FailureInjector.nic_loss(axis, step, straggler, ell,
                                              repair)
        ref = jax_fault.FailureInjector.nic_loss(axis, step, straggler, ell,
                                                 repair)
        for t in (1.0, 37.5, jax_lb.t0_fault_free(axis, N, 1)):
            b = base and fault.FaultState(axis, *base)
            jb = base and jax_fault.FaultState(axis, *base)
            assert _events(ours.to_timeline(t, b)) == \
                _events(ref.to_timeline(t, jb))
    assert outcome(fault.FailureInjector(4).to_timeline, 0.0) == \
        outcome(jax_fault.FailureInjector(4).to_timeline, 0.0)
    # the injector's timeline drives replay alike in both packages
    tl = fault.FailureInjector.nic_loss(P, 1, 2, 2.0, 3).to_timeline(200.0)
    jtl = jax_fault.FailureInjector.nic_loss(P, 1, 2, 2.0, 3).to_timeline(
        200.0)
    assert_replay_equal(
        planner.replay(_profiles(model)["healthy"], N, tl, k=K),
        jax_planner.replay(_profiles(jax_model)["healthy"], N, jtl, k=K))


def test_fault_state_materializes_as_jax():
    for state in ((4, None, 1.0), (4, 0, 1.5), (8, 3, 2.0)):
        for materialize in (False, True, "arrays"):
            got = fault.FaultState(*state).plan(1001, 4, materialize)
            want = jax_fault.FaultState(*state).plan(1001, 4, materialize)
            assert_plan_equal(got, want)
            assert (got.schedule is None) == (not materialize)
    got = fault.FaultState(4, 0, 1.5).plan(1001, materialize=True)
    want = jax_fault.FaultState(4, 0, 1.5).plan(1001, materialize=True)
    assert_schedule_equal(got.schedule, want.schedule)


def test_replay_telemetry_attributes_the_noreplan_run():
    """The no-replan run kept on the result feeds the observability layer
    as the JAX package's does."""
    from repro import obs as jax_obs

    from repro_torch import obs
    from repro_torch.core.simulator import simulate
    tl, jtl = _timeline(model, TRACES[0]), _timeline(jax_model, TRACES[0])
    got = planner.replay(_profiles(model)["straggler"], N, tl, k=K)
    want = jax_planner.replay(_profiles(jax_model)["straggler"], N, jtl, k=K)
    from repro.core.simulator import simulate as jax_simulate
    a = simulate(got.plan0.schedule, telemetry=True, timeline=got.timeline)
    b = jax_simulate(want.plan0.schedule, telemetry=True,
                     timeline=want.timeline)
    assert a.makespan == got.t_noreplan == want.t_noreplan
    assert_tree_equal(obs.stage_breakdown(a.telemetry),
               jax_obs.stage_breakdown(b.telemetry))
