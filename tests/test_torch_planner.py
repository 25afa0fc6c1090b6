"""The port's fault state and planner against the JAX package's, on a grid
of profiles: every number the runtime reads must be equal, not close."""
import pytest

pytest.importorskip("torch")

from repro.comms import fault as jax_fault  # noqa: E402
from repro_torch.comms import fault  # noqa: E402

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


def test_make_plan_rejects_unported_algo():
    with pytest.raises(ValueError):
        from repro_torch.core.planner import make_plan
        make_plan(fault.FaultState(4).profile(), 1000, algo="dbtree")
