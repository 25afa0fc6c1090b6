"""The port's schedule executor (torch) against the JAX package's (numpy):
for every distinct Flow-object schedule of the profile grid, at the
schedule's own n (odd and even), the outputs are equal to the bit in fp32
and in bf16 (JAX's arrays as `ml_dtypes.bfloat16`), and `verify_allreduce`
passes in both dtypes. A hand-built schedule in which one tensor is
reachable from two ranks pins the out-of-place accumulation."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.core import executor as jax_executor  # noqa: E402
from repro.core import model as jax_model  # noqa: E402
from repro_torch.core import executor, model  # noqa: E402
from repro_torch.core.planner import make_plan  # noqa: E402
from test_torch_flow_grid import (PROFILES, spec_id,  # noqa: E402
                                  unique_schedules)

SEED = 23


@pytest.fixture(autouse=True)
def _one_thread():
    """The executor's torch ops are many and small: one intra-op thread runs
    them far faster than a pool that must wake for each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(p: int, n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((p, n)).astype(
        np.float32)


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    """The tensor's bit patterns as unsigned numpy integers."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


def _np_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype == ml_dtypes.bfloat16 else np.uint32)


def assert_bit_equal_to_jax(want_schedule, got_schedule, x32: np.ndarray,
                            what="") -> None:
    for xa in (x32, x32.astype(ml_dtypes.bfloat16)):
        want = jax_executor.execute(want_schedule, xa)
        got = executor.execute(got_schedule, _to_torch(xa))
        assert got.dtype == _to_torch(xa).dtype and got.device.type == "cpu"
        assert np.array_equal(_bits(got), _np_bits(want)), (what, xa.dtype)


@pytest.mark.parametrize("spec", PROFILES, ids=spec_id)
def test_execute_equals_jax(spec):
    for i, (want, got) in enumerate(unique_schedules(spec)):
        what = (spec, got.algo, got.schedule.meta.get("k"), got.schedule.n)
        p, n = got.profile.p, int(got.schedule.n)
        assert n == got.schedule.n                # run at the schedule's n
        assert_bit_equal_to_jax(want.schedule, got.schedule,
                                _inputs(p, n, SEED + i), what)
        # small integers: every partial sum is exact in fp32 and in bf16,
        # so the default tolerances hold in both dtypes
        xi = torch.from_numpy(np.random.default_rng(SEED - i).integers(
            -8, 9, (p, n)).astype(np.float32))
        for xt in (xi, xi.to(torch.bfloat16)):
            executor.verify_allreduce(got.schedule, xt)


def _aliasing_schedule(mod):
    """Rank 2 ACCUMs key K into rank 0 (rank 0's buffer K becomes
    x0 + x2); rank 0 STOREs K to rank 1 (rank 1's buffer K is now that
    same tensor); rank 2 ACCUMs into K at rank 1; rank 0 then STOREs K on
    to rank 2. An executor that adds in place at rank 1 also changes rank
    0's K, and rank 2 receives x0 + 2 x2."""
    F, Op = mod.Flow, mod.Op
    key, n = ("K",), 8
    flows = [F(0, 2, 0, n, (), 0, n, Op.ACCUM, key),
             F(1, 0, 1, n, (0,), 0, n, Op.STORE, key),
             F(2, 2, 1, n, (1,), 0, n, Op.ACCUM, key),
             F(3, 0, 2, n, (2,), 0, n, Op.STORE, key)]
    return mod.Schedule(profile=mod.BandwidthProfile.healthy(3), n=n,
                        nic_flows=flows)


def test_store_then_accum_does_not_alias():
    x = _inputs(3, 8, SEED)
    ours, ref = _aliasing_schedule(model), _aliasing_schedule(jax_model)
    assert_bit_equal_to_jax(ref, ours, x)
    xt = torch.from_numpy(x)
    out = executor.execute(ours, xt)
    assert torch.equal(out[2], xt[0] + xt[2])
    assert torch.equal(out[1], xt[0] + xt[2])
    assert bool(out[0].isnan().all())          # rank 0 never received
    assert torch.equal(xt, torch.from_numpy(x))   # x is never written


def test_verify_allreduce_catches_a_missing_flow():
    prof = model.BandwidthProfile.single_straggler(4, 1.5, 2)
    sched = make_plan(prof, 4 * 37 + 3, 4, algo="optcc").schedule
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (4, 4 * 37 + 3)))
    executor.verify_allreduce(sched, x)
    last = max(sched.nic_flows, key=lambda f: f.fid)
    assert not any(last.fid in f.deps for f in sched.nic_flows)
    short = model.Schedule(profile=prof, n=sched.n,
                           nic_flows=[f for f in sched.nic_flows
                                      if f is not last],
                           meta=sched.meta)
    with pytest.raises(AssertionError, match=f"rank {last.dst} "):
        executor.verify_allreduce(short, x)


def test_execute_rejects_what_jax_rejects():
    """A flow before its dependency, and an input of the wrong rank count,
    raise as the JAX executor does."""
    def sched(mod):
        F, Op = mod.Flow, mod.Op
        flows = [F(0, 0, 1, 4, (1,), 0, 4, Op.STORE, ("x",)),
                 F(1, 1, 0, 4, (), 0, 4, Op.STORE, ("x",))]
        return mod.Schedule(profile=mod.BandwidthProfile.healthy(2), n=4,
                            nic_flows=flows)
    for bad, x in ((sched, np.ones((2, 4), np.float32)),
                   (sched, np.ones((3, 4), np.float32))):
        with pytest.raises(ValueError) as ours:
            executor.execute(bad(model), torch.from_numpy(x))
        with pytest.raises(ValueError) as ref:
            jax_executor.execute(bad(jax_model), x)
        assert str(ours.value) == str(ref.value)


def test_execute_clips_past_the_end_as_jax_does():
    """x's length is not checked against the schedule's n: ranges past its
    end are clipped, here and in the JAX package alike."""
    spec_n = 4 * 37 + 3
    prof = model.BandwidthProfile.single_straggler(4, 1.5, 2)
    jprof = jax_model.BandwidthProfile.single_straggler(4, 1.5, 2)
    from repro.core.planner import make_plan as jax_make_plan
    ours = make_plan(prof, spec_n, 4, algo="optcc").schedule
    ref = jax_make_plan(jprof, spec_n, 4, algo="optcc").schedule
    assert_bit_equal_to_jax(ref, ours, _inputs(4, spec_n // 3, SEED))
