"""Holds no tests: the profile grid and the helpers that
tests/test_torch_schedules.py, test_torch_simulator.py,
test_torch_executor.py and test_torch_replay.py share.

`PROFILES` is the grid of bandwidth profiles, `plan_pair` builds a plan on
both sides once per process (JAX's first), and the `assert_*_equal`
helpers hold the port's objects to the JAX package's exactly: `==` on
floats, `np.array_equal` on arrays, `Op` by its `.value` (the two packages
have two enum classes).
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import model as jax_model  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core import registry as jax_registry  # noqa: E402
from repro_torch.core import model, planner  # noqa: E402

KS = (1, 4, 16)
ELLS = (1.25, 1.5, 2.0, 3.0)


def _grid() -> tuple:
    """(kind, args) specs of the profile grid; `profile_of` builds them."""
    specs = [("healthy", (p,)) for p in (4, 8, 16)]
    for p in (3, 4, 5, 8, 16):
        for ell in ELLS:
            for s in sorted({0, p // 2, p - 1}):       # first, middle, last
                specs.append(("single", (p, ell, s)))
    for p in (8, 16):
        for ells in ((2.0, 1.5), (3.0, 2.0, 1.5)):
            specs.append(("multi", (p, ells)))
    for p in (8, 16):
        for g in (2, 4):
            for nv in (None, 12.0):
                specs.append(("gpu", (p, g, nv)))
    return tuple(specs)


PROFILES = _grid()
# the columnar twins are cheap: they are also held at p = 32 and 64
ARRAY_PROFILES = PROFILES + (
    ("healthy", (64,)), ("single", (32, 1.5, 7)), ("single", (64, 3.0, 63)),
    ("single", (64, 1.25, 0)), ("multi", (32, (2.0, 1.5))),
    ("multi", (64, (3.0, 2.0, 1.5))), ("gpu", (32, 4, None)),
    ("gpu", (64, 4, 12.0)), ("gpu", (64, 8, None)))


def ks_of(spec) -> tuple:
    """The k values a profile's schedules are built at: KS, except that a
    single straggler first or last at p = 16 skips k = 16, which the grid
    already holds at p = 16 with the straggler in the middle and at every
    position for p <= 8."""
    kind, args = spec
    if kind == "single" and args[0] == 16 and args[2] != 8:
        return KS[:2]
    return KS


def spec_id(spec) -> str:
    kind, args = spec
    return kind + "-" + "-".join(str(a).replace(" ", "") for a in args)


def profile_of(model_mod, spec):
    """Build the spec's BandwidthProfile with one package's model module."""
    BP = model_mod.BandwidthProfile
    kind, args = spec
    if kind == "healthy":
        return BP.healthy(*args)
    if kind == "single":
        p, ell, s = args
        return BP.single_straggler(p, ell, s)
    if kind == "multi":
        p, ells = args
        return BP.multi_straggler(p, list(ells))
    p, g, nv = args           # server 1 of p / g degraded at l = 2
    return dataclasses.replace(BP.single_straggler(p, 2.0, 1, g=g),
                               nvlink_mult=nv)


def n_of(spec, k: int, odd: bool) -> int:
    """The vector length a grid schedule is built (and executed) at: ragged
    against p and k, odd or even."""
    base = profile_of(model, spec).p * 37 * k + 6
    return base + 1 if odd else base


def outcome(fn, *args, **kw):
    """fn's result, or its exception as (type name, message)."""
    try:
        return fn(*args, **kw)
    except (ValueError, TypeError, NotImplementedError, AssertionError,
            ZeroDivisionError) as e:
        return ("raises", type(e).__name__, str(e))


@functools.lru_cache(maxsize=None)
def plan_pair(spec, name: str, k: int, fill: bool, materialize=True,
              odd: bool = True):
    """make_plan on both sides (JAX's first), or what each raised."""
    n = n_of(spec, k, odd)
    return tuple(outcome(mod.make_plan, profile_of(m, spec), n, k, fill,
                         materialize, name)
                 for mod, m in ((jax_planner, jax_model),
                                (planner, model)))


def grid_plans(spec):
    """Every (name, k, fill) of the grid on one profile: every supported
    registry name plus "auto", k in `ks_of(spec)`, fill_bubbles both ways.
    Schedules built at an odd n when fill_bubbles is on, at an even n when
    off."""
    names = jax_registry.supported(profile_of(jax_model, spec)) + ("auto",)
    for name in names:
        for k in ks_of(spec):
            for fill in (True, False):
                yield (name, k, fill), plan_pair(spec, name, k, fill,
                                                 True, fill)


def unique_schedules(spec):
    """The grid's distinct Flow-object schedules of one profile, each
    built once (the same cached pairs `grid_plans` compares): "auto" builds
    what "ring" or "optcc" builds, and the ring and the torus ignore k and
    fill_bubbles (fill_bubbles still picks an odd or an even n)."""
    names = jax_registry.supported(profile_of(jax_model, spec))
    for name in names:
        for k in (KS[:1] if name in ("ring", "torus2d") else ks_of(spec)):
            for fill in (True, False):
                want, got = plan_pair(spec, name, k, fill, True, fill)
                if not isinstance(want, tuple):
                    yield want, got


def flow_tuple(f) -> tuple:
    return (f.fid, f.src, f.dst, f.size, f.deps, f.lo, f.hi, f.op.value,
            f.key, f.pri, f.release,
            tuple((lo, hi, op.value, key) for lo, hi, op, key in f.extra))


def assert_meta_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), key
        else:
            assert type(g) is type(w) and g == w, key


def assert_arrays_equal(got, want) -> None:
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        assert g.dtype == w.dtype, field.name
        assert np.array_equal(g, w, equal_nan=field.name == "pri"), \
            field.name


def assert_schedule_equal(got, want) -> None:
    if want is None:
        assert got is None
        return
    assert got.n == want.n
    assert (got.profile.p, got.profile.slowdown, got.profile.gpus_per_server,
            got.profile.nvlink_mult) == \
        (want.profile.p, want.profile.slowdown, want.profile.gpus_per_server,
         want.profile.nvlink_mult)
    for attr in ("nic_flows", "nvlink_flows"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert [flow_tuple(f) for f in g] == [flow_tuple(f) for f in w], attr
    assert_meta_equal(got.meta, want.meta)
    assert (got.arrays is None) == (want.arrays is None)
    if want.arrays is not None:
        assert_arrays_equal(got.arrays, want.arrays)


def assert_descriptor_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "slots":
            assert list(got[key].items()) == list(w.items())
            assert len(got[key]) == len(w)
        else:
            assert got[key] == w, key


PLAN_FIELDS = ("algo", "topology", "lower_bound", "predicted_time", "t0",
               "predicted_overhead")


def assert_plan_equal(got, want) -> None:
    if isinstance(want, tuple):                 # JAX raised: so must we
        assert got == want
        return
    assert not isinstance(got, tuple), got
    for field in PLAN_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.profile.slowdown == want.profile.slowdown
    assert_descriptor_equal(got.descriptor, want.descriptor)
    assert_schedule_equal(got.schedule, want.schedule)




def assert_result_equal(got, want, what: str = "") -> None:
    assert got.makespan == want.makespan, what
    assert got.start == want.start, what
    assert got.finish == want.finish, what
    assert got.port_busy == want.port_busy, what


def assert_tree_equal(got, want, path="") -> None:
    """Dicts, lists and scalars equal; numpy arrays equal to the bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for key in want:
            assert_tree_equal(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_tree_equal(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert type(got) is type(want) and got == want, path
