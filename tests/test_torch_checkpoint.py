"""The port's checkpoint module against the JAX package's: the substrate
tests run on both packages, checkpoints restore bit for bit in both
directions (fp32 and bf16 train states) with equal meta.msgpack bytes and
equal npz members, an async save keeps the values of the moment it was
called, and the port's msgpack codec writes what `msgpack.packb` writes."""
import dataclasses
import threading
import zipfile

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.checkpoint import ckpt as ckpt_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import TrainState, init_train_state  # noqa: E402
from jax_reference import flat_numpy  # noqa: E402


# --- the JAX substrate tests (tests/test_train_substrate.py), each run on
# --- both packages through the same few calls

def _jax_tree(a, b):
    return {"a": jnp.asarray(a), "nested": {"b": jnp.asarray(b, jnp.bfloat16)}}


def _port_tree(a, b):
    return {"a": torch.tensor(a),
            "nested": {"b": torch.tensor(b).to(torch.bfloat16)}}


PACKAGES = {
    "jax": (jckpt, _jax_tree, lambda x: np.asarray(x, np.float32)),
    "port": (ckpt, _port_tree, lambda x: x.float().numpy()),
}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_checkpoint_roundtrip(tmp_path, pkg):
    mod, tree_of, to_np = PACKAGES[pkg]
    a = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    b = np.ones((4,), np.float32)
    mod.save(tmp_path, 5, tree_of(a, b), meta={"note": "x"})
    mod.save(tmp_path, 9, tree_of(a * 2, b * 2))
    assert mod.latest_step(tmp_path) == 9
    out, meta = mod.restore(tmp_path, tree_of(a * 0, b * 0))
    np.testing.assert_array_equal(to_np(out["a"]), a * 2)
    np.testing.assert_array_equal(to_np(out["nested"]["b"]), b * 2)
    assert meta == {"step": 9}
    out5, meta5 = mod.restore(tmp_path, tree_of(a * 0, b * 0), step=5)
    assert meta5 == {"step": 5, "note": "x"}
    np.testing.assert_array_equal(to_np(out5["a"]), a)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_checkpoint_atomicity(tmp_path, pkg):
    mod, tree_of, _ = PACKAGES[pkg]
    tree = tree_of(np.zeros(3, np.float32), np.zeros(4, np.float32))
    mod.save(tmp_path, 1, tree)
    # a stale tmp dir from a crashed save must not count as a checkpoint,
    # nor a step directory whose meta was never written
    (tmp_path / ".tmp_step_2").mkdir()
    mod.save(tmp_path, 3, tree)
    (tmp_path / "step_3" / "meta.msgpack").unlink()
    assert mod.latest_step(tmp_path) == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_checkpoint_shape_mismatch_rejected(tmp_path, pkg):
    mod, tree_of, _ = PACKAGES[pkg]
    mod.save(tmp_path, 1, tree_of(np.zeros((2, 2), np.float32),
                                  np.zeros(4, np.float32)))
    with pytest.raises(ValueError, match="shape mismatch"):
        mod.restore(tmp_path, tree_of(np.zeros((3, 3), np.float32),
                                      np.zeros(4, np.float32)))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_checkpoint_missing_key_rejected(tmp_path, pkg):
    mod, tree_of, _ = PACKAGES[pkg]
    tree = tree_of(np.zeros(2, np.float32), np.zeros(4, np.float32))
    mod.save(tmp_path, 1, {"a": tree["a"]})
    with pytest.raises(KeyError, match="checkpoint missing array nested/b"):
        mod.restore(tmp_path, tree)
    # extra arrays in the checkpoint are ignored
    mod.save(tmp_path, 2, tree)
    out, _ = mod.restore(tmp_path, {"a": tree["a"]})
    assert list(out) == ["a"]


def test_restore_is_in_place_and_casts(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.arange(5.0) + 0.3,
                            "n": torch.tensor([1, 2], dtype=torch.int32)})
    w = torch.zeros(5, dtype=torch.bfloat16)
    n = torch.zeros(2, dtype=torch.int64)
    out, _ = ckpt.restore(tmp_path, {"w": w, "n": n})
    assert out["w"] is w and out["n"] is n
    assert torch.equal(w, (torch.arange(5.0) + 0.3).to(torch.bfloat16))
    assert n.tolist() == [1, 2]


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The writer thread is held until the live tensors have been changed
    in place (as AdamW changes them): the checkpoint must still hold the
    values of the moment `save` was called."""
    gate = threading.Event()
    write = ckpt_mod._write_npz

    def held_write(path, members):
        assert gate.wait(timeout=30)
        write(path, members)

    monkeypatch.setattr(ckpt_mod, "_write_npz", held_write)
    params = {"w": torch.arange(1000.0), "b": torch.ones(7).bfloat16()}
    before = {k: v.clone() for k, v in params.items()}
    thread = ckpt.save(tmp_path, 3, params, async_=True)
    for v in params.values():
        v.mul_(-2.0).add_(1.0)
    gate.set()
    thread.join(timeout=30)
    assert not thread.is_alive()
    out, meta = ckpt.restore(tmp_path, {k: torch.zeros_like(v)
                                        for k, v in params.items()})
    assert meta == {"step": 3}
    for k in params:
        assert torch.equal(out[k], before[k]), k


# --- bit for bit against the JAX package, both directions

def _jax_state(bf16: bool):
    """JAX's smoke qwen3 train state at init, its moments filled with
    random values (zeros would not show a mu/nu swap), count 3, step 7."""
    cfg = jax_get_config("qwen3-1.7b", smoke=True)
    if bf16:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    opt = JaxAdamWConfig(moment_dtype="bfloat16" if bf16 else "float32")
    state = jax_init_train_state(jax_build_model(cfg), opt)
    rng = np.random.default_rng(5)
    moments = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        {k: state.opt_state[k] for k in ("mu", "nu")})
    opt_state = {**moments, "count": jnp.asarray(3, jnp.int32)}
    return state.replace(opt_state=opt_state, step=jnp.asarray(7, jnp.int32))


def _port_template(bf16: bool):
    """The port's own init of the same config: other values, same tree."""
    cfg = get_config("qwen3-1.7b", smoke=True)
    if bf16:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    opt = AdamWConfig(moment_dtype="bfloat16" if bf16 else "float32")
    return init_train_state(build_model(cfg), opt, seed=3, device="cpu")


def _bits(x) -> np.ndarray:
    """An array's bytes as unsigned ints of its width (bf16 without
    ml_dtypes; a Python int leaf as the int32 the format stores)."""
    if isinstance(x, int):
        x = np.asarray(x, np.int32)
    if isinstance(x, torch.Tensor):
        x = x.detach().view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}")


def _port_flat(state) -> dict:
    return dict(ckpt_mod.leaves(state))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_jax_checkpoint_restores_bit_for_bit_in_the_port(tmp_path, bf16):
    jstate = _jax_state(bf16)
    jckpt.save(tmp_path, 7, jstate, meta={"note": "x"})
    template = _port_template(bf16)
    want = flat_numpy(jstate)
    # the port's own conversion of the same JAX state
    converted = params_from_numpy(
        {k[2:]: v for k, v in want.items() if k.startswith("0/")}, "cpu")
    converted_opt = opt_state_from_numpy(
        {k[2:]: v for k, v in want.items() if k.startswith("1/")}, "cpu")
    state, meta = ckpt.restore(tmp_path, template)
    assert meta == {"step": 7, "note": "x"}
    assert isinstance(state.step, int) and state.step == 7
    assert state.params["embed"] is template.params["embed"]
    got = _port_flat(state)
    assert list(got) == list(want)
    for k, v in want.items():
        assert _bits(got[k]).tobytes() == _bits(v).tobytes(), k
    dt = torch.bfloat16 if bf16 else torch.float32
    for k, v in state.params.items():
        assert v.dtype == dt
        assert _bits(v).tobytes() == _bits(converted[k]).tobytes(), k
    for g in ("mu", "nu"):
        for k, v in state.opt_state[g].items():
            assert _bits(v).tobytes() == \
                _bits(converted_opt[g][k]).tobytes(), (g, k)
    assert int(state.opt_state["count"]) == 3


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_port_checkpoint_restores_bit_for_bit_in_jax(tmp_path, bf16):
    jstate = _jax_state(bf16)
    # the port's state: JAX's values, through the port's restore
    jckpt.save(tmp_path / "jax", 7, jstate, meta={"note": "x"})
    pstate, _ = ckpt.restore(tmp_path / "jax", _port_template(bf16))
    ckpt.save(tmp_path / "port", 7, pstate, meta={"note": "x"})
    template = jax.tree.map(jnp.zeros_like, jstate)
    out, meta = jckpt.restore(tmp_path / "port", template)
    assert meta == {"step": 7, "note": "x"}
    got, want = flat_numpy(out), flat_numpy(jstate)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert _bits(got[k]).tobytes() == _bits(v).tobytes(), k
    # the two writers' files: equal meta bytes, equal npz members (each
    # .npy header and data; only the zip's timestamps differ)
    jdir, pdir = tmp_path / "jax" / "step_7", tmp_path / "port" / "step_7"
    assert (jdir / "meta.msgpack").read_bytes() == \
        (pdir / "meta.msgpack").read_bytes()
    with zipfile.ZipFile(jdir / "arrays.npz") as zj, \
            zipfile.ZipFile(pdir / "arrays.npz") as zp:
        assert zj.namelist() == zp.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zp.read(name), name


def test_checkpoint_rejects_what_it_cannot_store(tmp_path):
    with pytest.raises(TypeError):
        ckpt.save(tmp_path, 1, {"c": torch.zeros(2, dtype=torch.complex64)})
    with pytest.raises(TypeError):
        ckpt.save(tmp_path, 1, {"a": [torch.zeros(2)]})
    with pytest.raises(ValueError):
        ckpt.save(tmp_path, 1, TrainState({}, {}, 2 ** 31))


# --- the msgpack codec

_SCALAR = (st.none() | st.booleans()
           | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
           | st.floats(allow_nan=False) | st.text())
_VALUE = st.recursive(
    _SCALAR, lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(), inner, max_size=20), max_leaves=60)
_MAP = st.dictionaries(st.text(), _VALUE, max_size=20)


@settings(max_examples=100, deadline=None)
@given(_MAP)
def test_msgpack_encode_decode_match_packb(x):
    packed = msgpack.packb(x)
    assert _msgpack.encode(x) == packed
    assert _msgpack.decode(packed) == x


_EDGE_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 63, 2 ** 64 - 1, -1, -31, -32, -33, -127, -128, -129,
              -32767, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


@pytest.mark.parametrize("x", [
    {"s": "a" * n} for n in (0, 31, 32, 255, 256, 65535, 65536)
] + [{"s": "é" * 16}] + [
    {"i": i} for i in _EDGE_INTS
] + [
    {f"k{i}": i for i in range(n)} for n in (15, 16, 65536)
] + [
    {"l": list(range(n))} for n in (15, 16, 65536)
] + [
    {"f": f} for f in (0.0, -0.0, 1.5, 1e308, float("inf"), float("-inf"))
] + [
    {"n": None, "t": True, "f": False, "m": {"x": {"y": [1, "z", None]}}},
], ids=lambda x: repr(x)[:40])
def test_msgpack_width_boundaries(x):
    packed = msgpack.packb(x)
    assert _msgpack.encode(x) == packed
    assert _msgpack.decode(packed) == x


def test_msgpack_nan_encodes_as_packb():
    assert _msgpack.encode({"f": float("nan")}) == \
        msgpack.packb({"f": float("nan")})


@pytest.mark.parametrize("x, err", [
    ({"b": b"bytes"}, TypeError), ({"t": (1, 2)}, TypeError),
    ({1: "int key"}, TypeError), ({"s": {1.5}}, TypeError),
    ({"a": np.int64(3)}, TypeError), ({"i": 2 ** 64}, ValueError),
    ({"i": -2 ** 63 - 1}, ValueError), ([1, 2], TypeError),
])
def test_msgpack_rejects_outside_the_subset(x, err):
    with pytest.raises(err):
        _msgpack.encode(x)


@pytest.mark.parametrize("data", [
    msgpack.packb({"b": b"bytes"}), msgpack.packb([1]),
    msgpack.packb({1: 2}),
    msgpack.packb({"a": 1})[:-1], msgpack.packb({"a": 1}) + b"\x00",
    msgpack.packb({"f": 1.5}, use_single_float=True),
])
def test_msgpack_decode_rejects_outside_the_subset(data):
    with pytest.raises(ValueError):
        _msgpack.decode(data)
