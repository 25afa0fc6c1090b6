"""The port's fault state and planner against the JAX package's, on a grid
of profiles: every number the runtime reads must be equal, not close."""
import pytest

pytest.importorskip("torch")

from repro.comms import fault as jax_fault  # noqa: E402
from repro.core import model as jax_model  # noqa: E402
from repro.core import registry as jax_registry  # noqa: E402
from repro.core.planner import make_plan as jax_make_plan  # noqa: E402
from repro_torch.comms import fault  # noqa: E402
from repro_torch.core import model  # noqa: E402
from repro_torch.core.planner import make_plan  # noqa: E402
from test_torch_flow_grid import (PROFILES, outcome,  # noqa: E402
                                  assert_plan_equal, profile_of)

ELLS = (1.0, 1.25, 1.5, 2.0, 3.0)
NS = (1000, int(1.7e9))


def _stragglers(p):
    return range(p) if p <= 4 else (0, 1, p // 2, p - 1)


@pytest.mark.parametrize("p", [3, 4, 8, 16])
@pytest.mark.parametrize("ell", ELLS)
def test_fault_state_plan_equals_jax(p, ell):
    states = [(None, 1.0)] + [(s, ell) for s in _stragglers(p)]
    for straggler, l in states:
        ours = fault.FaultState(p, straggler, l)
        ref = jax_fault.FaultState(p, straggler, l)
        assert ours.degraded == ref.degraded
        a, b = ours.profile(), ref.profile()
        assert (a.p, a.slowdown, a.gpus_per_server) == \
            (b.p, b.slowdown, b.gpus_per_server)
        for n in NS:
            got, want = ours.plan(n), ref.plan(n)
            for field in ("algo", "topology", "lower_bound",
                          "predicted_time", "t0", "predicted_overhead"):
                assert getattr(got, field) == getattr(want, field), \
                    (p, straggler, l, n, field)


def test_nic_loss_events_equal_jax():
    ours = fault.FailureInjector.nic_loss(4, 2, 1, 1.5, repair_step=4)
    ref = jax_fault.FailureInjector.nic_loss(4, 2, 1, 1.5, repair_step=4)
    assert sorted(ours.events) == sorted(ref.events) == [2, 4]
    for step, st in ours.events.items():
        want = ref.events[step]
        assert (st.axis_size, st.straggler, st.ell) == \
            (want.axis_size, want.straggler, want.ell)
    cur_o, cur_r = fault.FaultState(4), jax_fault.FaultState(4)
    for step in range(6):
        cur_o, cur_r = ours.at_step(step, cur_o), ref.at_step(step, cur_r)
        assert (cur_o.straggler, cur_o.ell, cur_o.degraded) == \
            (cur_r.straggler, cur_r.ell, cur_r.degraded)
        assert fault.FaultAwareSync(cur_o).grad_sync_kind() == \
            jax_fault.FaultAwareSync(cur_r).grad_sync_kind()


@pytest.mark.parametrize("name", jax_registry.names())
def test_make_plan_every_registry_name_equals_jax(name):
    """make_plan(algo=name) for every registered name on the profile grid
    (descriptor-only plans; tests/test_torch_schedules.py holds the
    materialized ones): equal plans, or the same error where the JAX
    package refuses the profile."""
    for spec in PROFILES:
        for n in NS:
            for k in (1, 16):
                want = outcome(jax_make_plan, profile_of(jax_model, spec), n,
                             k, materialize=False, algo=name)
                got = outcome(make_plan, profile_of(model, spec), n, k,
                            materialize=False, algo=name)
                assert_plan_equal(got, want)


def test_make_plan_refuses_what_jax_refuses():
    """An unknown name, and a registered one on a profile it does not
    support, raise ValueError with the JAX package's message."""
    cases = (("nope", ("healthy", (4,))),
             ("hierarchical", ("single", (8, 2.0, 1))),
             ("torus2d", ("single", (5, 1.5, 2))),
             ("torus2d", ("gpu", (16, 4, None))),
             ("dbtree", ("gpu", (8, 2, 12.0))))
    for name, spec in cases:
        with pytest.raises(ValueError) as ours:
            make_plan(profile_of(model, spec), 1000, algo=name)
        with pytest.raises(ValueError) as ref:
            jax_make_plan(profile_of(jax_model, spec), 1000, algo=name)
        assert str(ours.value) == str(ref.value)
