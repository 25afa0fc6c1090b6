"""The port's flow model against the JAX package's, exactly: the schedule
generators (Flow objects and the columnar "arrays" twins), the registry, the
planner's plans and slot descriptors, and every lower bound and time model.

Both sides are the same numpy program, so every float is held with `==`,
every array with `np.array_equal` and every `Op` by its `.value` (the two
packages have two enum classes): a difference is a bug, not rounding.
The profile grid and the cached plan pairs are tests/test_torch_flow_grid.py's.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import lower_bounds as jax_lb  # noqa: E402
from repro.core import model as jax_model  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core import registry as jax_registry  # noqa: E402
from repro.core import ring as jax_ring  # noqa: E402
from repro.core import topologies as jax_topologies  # noqa: E402
from repro_torch.core import baselines, lower_bounds, model, planner  # noqa: E402
from repro_torch.core import registry, ring, topologies  # noqa: E402
from test_torch_flow_grid import (KS, PROFILES, ARRAY_PROFILES,  # noqa: E402
                                  assert_descriptor_equal, assert_plan_equal,
                                  assert_schedule_equal, grid_plans, n_of,
                                  outcome, plan_pair, profile_of, spec_id)


@pytest.mark.parametrize("spec", PROFILES, ids=spec_id)
def test_plans_and_schedules_equal_jax(spec):
    """Every Flow of every plan on the grid, field by field, with its meta,
    plan fields and descriptor; unsupported combinations raise alike."""
    jp, tp = profile_of(jax_model, spec), profile_of(model, spec)
    assert registry.supported(tp) == jax_registry.supported(jp)
    for combo, (want, got) in grid_plans(spec):
        try:
            assert_plan_equal(got, want)
        except AssertionError as e:
            raise AssertionError(f"{spec} {combo}: {e}") from e


@pytest.mark.parametrize("spec", ARRAY_PROFILES, ids=spec_id)
def test_array_twins_equal_jax(spec):
    """The columnar "arrays" schedules (ring and the OptCC family, through
    make_plan and through their generators) column for column."""
    from repro.core import schedule_vec as jax_vec

    from repro_torch.core import schedule_vec
    jp, tp = profile_of(jax_model, spec), profile_of(model, spec)
    for k in KS:
        for fill in (True, False):
            for name in ("ring", "optcc", "auto"):
                want, got = plan_pair(spec, name, k, fill, "arrays")
                assert_plan_equal(got, want)
            n = n_of(spec, k, fill)
            want = outcome(jax_vec.optcc_schedule_arrays, jp, n, k, fill)
            got = outcome(schedule_vec.optcc_schedule_arrays, tp, n, k, fill)
            if isinstance(want, tuple):
                assert got == want
            else:
                assert_schedule_equal(got, want)
    n = n_of(spec, 1, True)
    assert_schedule_equal(schedule_vec.ring_arrays(tp, n),
                          jax_vec.ring_arrays(jp, n))


@pytest.mark.parametrize("spec", PROFILES + (("healthy", (1024,)),
                                             ("single", (1024, 1.5, 3))),
                         ids=spec_id)
def test_plan_descriptor_equal_jax(spec):
    jp, tp = profile_of(jax_model, spec), profile_of(model, spec)
    for k in KS:
        for n in (n_of(spec, k, True), 1 << 20, 1720574976):
            assert_descriptor_equal(planner.plan_descriptor(tp, n, k),
                                    jax_planner.plan_descriptor(jp, n, k))
            want = jax_planner.make_plan(jp, n, k, materialize=False)
            assert_plan_equal(planner.make_plan(tp, n, k, materialize=False),
                              want)


def _same(fn_name: str, ours, ref, *args) -> None:
    got = outcome(getattr(ours, fn_name), *args)
    want = outcome(getattr(ref, fn_name), *args)
    assert type(got) is type(want) and got == want, (fn_name, args)


@pytest.mark.parametrize("spec", PROFILES, ids=spec_id)
def test_bounds_and_time_models_equal_jax(spec):
    """Every bound and time model of lower_bounds, baselines and the
    registry entries, on the profile and on the paper's scalar arguments."""
    jp, tp = profile_of(jax_model, spec), profile_of(model, spec)
    p, g = tp.p, tp.gpus_per_server
    ells = [l for l in tp.slowdown if l > 1.0]
    ell = max(tp.slowdown)
    for n in (n_of(spec, 4, True), 1 << 20, 1720574976.0):
        for fn in ("t0_fault_free",):
            _same(fn, lower_bounds, jax_lb, p, n, g)
        for fn in ("lb_single_straggler", "lb_single_straggler_tight"):
            _same(fn, lower_bounds, jax_lb, p, n, ell)
        _same("lb_multi_straggler", lower_bounds, jax_lb, p, n, ells)
        for fn in ("lb_multi_gpu", "lb_multi_gpu_tight"):
            _same(fn, lower_bounds, jax_lb, p, n, ell, max(g, 2))
        _same("lower_bound", lower_bounds, jax_lb, p, n, ells, g)
        _same("optcc_time_asymptotic", lower_bounds, jax_lb, p, n, ells, g)
        for fn in ("lb_dbtree", "lb_torus2d", "lb_hierarchical"):
            if fn == "lb_hierarchical" and g == 1:
                continue
            got = outcome(getattr(lower_bounds, fn), tp, n)
            want = outcome(getattr(jax_lb, fn), jp, n)
            assert got == want, fn
        for k in KS:
            _same("optcc_time_single", lower_bounds, jax_lb, p, n, ell, k)
            _same("optcc_time_multi", lower_bounds, jax_lb, p, n, ells, k)
            _same("optcc_time_multi_gpu", lower_bounds, jax_lb, p, n, ell,
                  max(g, 2), k)
            _same("optcc_time", lower_bounds, jax_lb, p, n, ells, k, g)
            for fn in ("dbtree_time", "torus2d_time", "hierarchical_time"):
                if fn == "hierarchical_time" and g == 1:
                    continue
                got = outcome(getattr(lower_bounds, fn), tp, n, k)
                want = outcome(getattr(jax_lb, fn), jp, n, k)
                assert got == want, fn
            for name in jax_registry.names():
                ours, ref = registry.get(name), jax_registry.get(name)
                assert ours.supports(tp) == ref.supports(jp), name
                if not ref.supports(jp):
                    continue
                assert outcome(ours.time_model, tp, n, k) == \
                    outcome(ref.time_model, jp, n, k), name
                assert outcome(ours.lower_bound, tp, n) == \
                    outcome(ref.lower_bound, jp, n), name
        _same("nccl_no_failure_time", baselines, jax_baselines, p, n, g)
        for fn in ("iccl_time_asymptotic", "r2ccl_time"):
            _same(fn, baselines, jax_baselines, p, n, ell, g)
    n = n_of(spec, 1, True)
    assert baselines.iccl_time_simulated(tp, n) == \
        jax_baselines.iccl_time_simulated(jp, n)


def test_registry_entries_equal_jax():
    assert registry.names() == jax_registry.names()
    assert [a.name for a in registry.auto_candidates()] == \
        [a.name for a in jax_registry.auto_candidates()]
    for name in jax_registry.names():
        ours, ref = registry.get(name), jax_registry.get(name)
        for field in ("name", "description", "auto", "wins_when"):
            assert getattr(ours, field) == getattr(ref, field), (name, field)
        assert (ours.generate_arrays is None) == (ref.generate_arrays is None)
    with pytest.raises(ValueError) as ours_err:
        registry.get("nope")
    with pytest.raises(ValueError) as ref_err:
        jax_registry.get("nope")
    assert str(ours_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="already registered"):
        registry.register(registry.get("ring"))


def test_registry_register_adds_a_name():
    """`register` puts a new entry behind `get`, `names` and `supported`
    (removed again after the test)."""
    entry = dataclasses.replace(registry.get("ring"), name="ring-copy",
                                auto=False)
    try:
        registry.register(entry)
        assert registry.get("ring-copy") is entry
        assert "ring-copy" in registry.names()
        prof = model.BandwidthProfile.single_straggler(8, 2.0)
        assert "ring-copy" in registry.supported(prof)
        plan = planner.make_plan(prof, 1001, 4, algo="ring-copy")
        want = jax_planner.make_plan(
            jax_model.BandwidthProfile.single_straggler(8, 2.0), 1001, 4,
            algo="ring")
        assert_schedule_equal(plan.schedule, want.schedule)
    finally:
        registry._REGISTRY.pop("ring-copy", None)
    assert "ring-copy" not in registry.names()


@pytest.mark.parametrize("p", [2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 31, 64, 1024])
def test_topology_helpers_equal_jax(p):
    assert topologies.torus_dims(p) == jax_topologies.torus_dims(p)
    for n in (p * 37 + 5, 1 << 20):
        assert np.array_equal(topologies.dbtree_traffic(p, n),
                              jax_topologies.dbtree_traffic(p, n))
        if topologies.torus_dims(p) is not None:
            for per_phase in (False, True):
                got = topologies.torus2d_traffic(p, n, per_phase)
                want = jax_topologies.torus2d_traffic(p, n, per_phase)
                got, want = np.asarray(got), np.asarray(want)
                assert np.array_equal(got, want)
        assert np.array_equal(ring.split_points(n, p),
                              jax_ring.split_points(n, p))
    if p % 4 == 0 and p >= 12:
        spec = ("gpu", (p, 4, None))
        jp, tp = profile_of(jax_model, spec), profile_of(model, spec)
        assert topologies.server_slowdowns(tp) == \
            jax_topologies.server_slowdowns(jp)
        assert topologies.hierarchical_inner_profile(tp).slowdown == \
            jax_topologies.hierarchical_inner_profile(jp).slowdown


def test_stage_vocabulary_and_meta_contract_equal_jax():
    assert model.STAGE_NAMES == jax_model.STAGE_NAMES
    assert model.STAGE_ID == jax_model.STAGE_ID
    assert [op.value for op in model.Op] == [op.value for op in jax_model.Op]
    spec = ("single", (8, 1.5, 3))
    want, got = plan_pair(spec, "optcc", 4, True)
    model.validate_schedule_meta(got.schedule)
    bad = dataclasses.replace(got.schedule, meta={"algo": "optcc-single"})
    jbad = dataclasses.replace(want.schedule, meta={"algo": "optcc-single"})
    assert outcome(model.validate_schedule_meta, bad) == \
        outcome(jax_model.validate_schedule_meta, jbad)
