"""The port's roofline (`repro_torch.roofline`): `op_count` on the cases of
tests/test_hlo_parse.py (exact dot FLOPs, a loop of 7, a nested loop,
bytes in range, no collectives), `Roofline`'s arithmetic on the H100's
constants, the `meta` count against `torch.utils.flop_counter` on real CPU
tensors, the kernels' count-only path on `meta`, and every smoke config's
gradient dot FLOPs against the JAX package's HLO count (`analyze_hlo`,
run in one subprocess)."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.wkv import kernel as wkv  # noqa: E402
from repro_torch.kernels.wkv import ops as wkv_ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,  # noqa: E402
                                  Roofline, analyze_program)
from repro_torch.roofline.op_count import (meta_like,  # noqa: E402
                                           top_flop_ops)
from repro_torch.sharding import eval_shape  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
from jax_reference import gspmd_batch  # noqa: E402

GRAD_B, GRAD_S = 2, 256          # each smoke config's gradient batch
CHUNKED_S = 2048                 # qwen3-smoke past the direct threshold

_JAX_FLOPS = r"""
import json, sys
import jax
sys.path.insert(0, sys.argv[2])
from jax_reference import gspmd_batch
from repro.configs import ARCH_IDS, get_config
from repro.models import build_model
from repro.roofline.hlo_parse import analyze_hlo
B, S, S_CHUNKED = (int(x) for x in sys.argv[3:6])
cases = [(a, None, S) for a in ARCH_IDS] + [
    ("qwen3-1.7b", "full", S), ("qwen3-1.7b", None, S_CHUNKED)]
out = {}
for arch, remat, s in cases:
    cfg = get_config(arch, smoke=True)
    if remat:
        cfg = cfg.replace(remat=remat)
    model = build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in gspmd_batch(cfg, B, s).items()}
    text = jax.jit(jax.grad(model.loss)).lower(params, batch).compile() \
        .as_text()
    out[f"{arch}|{remat}|{s}"] = analyze_hlo(text).flops
json.dump(out, open(sys.argv[1], "w"))
"""


def _meta_grad_flops(cfg, B: int, S: int):
    """The port's count of the loss gradient of cfg on a B x S batch, on
    `meta` tensors."""
    model = build_model(cfg)
    params = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              .requires_grad_(True)
              for k, v in eval_shape(model.init, 0, device="cpu").items()}
    batch = meta_like({k: torch.from_numpy(v).long() if v.dtype == np.int32
                       else torch.from_numpy(v)
                       for k, v in gspmd_batch(cfg, B, S).items()})
    count, _ = analyze_program(
        lambda p, b: torch.autograd.grad(model.loss(p, b), list(p.values())),
        params, batch)
    return count


@pytest.fixture(scope="module")
def grad_flops(tmp_path_factory):
    """{case: (port's count, JAX's HLO count)} for every smoke config's
    gradient at (2, 256), qwen3 also with remat "full" and at S 2048."""
    out = tmp_path_factory.mktemp("roofline") / "jax_flops.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_FLOPS, str(out), str(REPO / "tests"),
         str(GRAD_B), str(GRAD_S), str(CHUNKED_S)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = {}
        for arch in ARCH_IDS:
            port[f"{arch}|None|{GRAD_S}"] = _meta_grad_flops(
                get_config(arch, smoke=True), GRAD_B, GRAD_S)
        qwen3 = get_config("qwen3-1.7b", smoke=True)
        port[f"qwen3-1.7b|full|{GRAD_S}"] = _meta_grad_flops(
            qwen3.replace(remat="full"), GRAD_B, GRAD_S)
        port[f"qwen3-1.7b|None|{CHUNKED_S}"] = _meta_grad_flops(
            qwen3, GRAD_B, CHUNKED_S)
        log, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    jax_flops = json.loads(out.read_text())
    return {k: (port[k], jax_flops[k]) for k in port}


# ----------------------------------------------------------------------------
# op_count on tests/test_hlo_parse.py's cases
# ----------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_dot_flops_exact():
    a, _ = analyze_program(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert a.flops == 2 * 64 * 128 * 32
    assert a.op_counts == {"aten.mm": 1}


def test_loop_of_seven():
    def f(w, x):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    a, _ = analyze_program(f, _meta(32, 32), _meta(8, 32))
    assert a.flops == 7 * 2 * 8 * 32 * 32
    assert a.op_counts["aten.mm"] == 7
    assert top_flop_ops(a) == [(a.flops, "aten.mm", 7)]


def test_nested_loop_multiplies():
    def f(w, x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    a, _ = analyze_program(f, _meta(16, 16), _meta(4, 16))
    assert a.flops == 15 * 2 * 4 * 16 * 16


def test_hbm_bytes_reasonable():
    """At least one read of x, at most a handful of round trips: eager
    (x * 2 + 1).sum() reads and writes x's size twice, then reads it."""
    nbytes = 1024 * 1024 * 4
    a, _ = analyze_program(lambda x: (x * 2 + 1).sum(), _meta(1024, 1024))
    assert nbytes * 0.5 <= a.hbm_bytes <= nbytes * 6
    assert a.hbm_bytes == 5 * nbytes + 4     # the scalars are not tensors


def test_no_collectives_single_device():
    a, _ = analyze_program(lambda x: x.sum(), _meta(128))
    assert a.collective_bytes == 0
    assert a.n_collectives == 0 and a.collective_by_kind == {}


def test_views_and_allocations_move_no_bytes():
    a, _ = analyze_program(
        lambda x: torch.empty_like(x).t().unsqueeze(0)[:, :10], _meta(64, 32))
    assert a.hbm_bytes == 0
    assert a.flops == 0


def test_peak_live_bytes_follows_frees():
    """The arguments count from the start; a temporary counts until it is
    freed, so two of them alive at once set the peak."""
    n = 1 << 20

    def f(x):
        y = x * 2           # x and y live
        z = y + 1           # x, y, z
        del y
        return z * 3        # x, z and the result

    a, _ = analyze_program(f, _meta(n))
    assert a.peak_live_bytes == 3 * 4 * n


def test_matches_torch_flop_counter_on_real_tensors():
    """qwen3-smoke's gradient: the count on `meta` equals
    torch.utils.flop_counter's on the same program run on CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg)
    params = {k: v.requires_grad_(True)
              for k, v in model.init(0, "cpu").items()}
    batch = {k: torch.from_numpy(v).long()
             for k, v in gspmd_batch(cfg, 2, 64).items()}
    counter = FlopCounterMode(display=False)
    with counter:
        torch.autograd.grad(model.loss(params, batch), list(params.values()))
    meta, _ = analyze_program(
        lambda p, b: torch.autograd.grad(model.loss(p, b), list(p.values())),
        meta_like(params), meta_like(batch))
    assert meta.flops == counter.get_total_flops() > 0


# ----------------------------------------------------------------------------
# the kernels on `meta`: their work recorded, an empty output returned
# ----------------------------------------------------------------------------

def test_meta_device_only_when_named():
    assert resolve_device("meta") == torch.device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("xpu")


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=0, q_offset=0, kv_len=48),
    dict(causal=True, window=16, q_offset=0, kv_len=48),
    dict(causal=False, window=0, q_offset=0, kv_len=30),
    dict(causal=True, window=0, q_offset=47, kv_len=48)])
def test_flash_attention_on_meta_counts_the_kernel(kw):
    Sq = 1 if kw["q_offset"] else 48
    q = torch.empty(2, Sq, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 48, 2, 64, dtype=torch.bfloat16, device="meta")
    v = torch.empty_like(k)
    a, out = analyze_program(lambda q, k, v: flash_ops.flash_attention(
        q, k, v, **kw), q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype and out.is_meta
    flops, nbytes = flash.work(q, k, v, **kw)
    route = flash.pick_route(q, k, v)
    assert route == ("flash_decode" if Sq == 1 else "flash_prefill")
    assert a.op_counts[route] == 1 and a.flops == flops
    assert a.hbm_bytes == nbytes
    # the rule: 4 hd flops per visible (row, key) pair and query head
    iq = kw["q_offset"] + np.arange(Sq)[:, None]
    jk = np.arange(kw["kv_len"])[None, :]
    seen = np.broadcast_to(jk <= iq if kw["causal"] else True,
                           (Sq, kw["kv_len"])).copy()
    if kw["window"]:
        seen &= jk > iq - kw["window"]
    assert flops == 4 * 64 * 8 * 2 * int(seen.sum())
    assert nbytes == 2 * q.numel() * 2 + 2 * 2 * kw["kv_len"] * 2 * 64 * 2
    assert flash.launches == {n: 0 for n in flash.launches} or \
        torch.cuda.is_available()


def test_wkv_on_meta_counts_the_kernel():
    B, S, H, hd = 2, 17, 4, 16
    x = [torch.empty(B, S, H, hd, device="meta") for _ in range(4)]
    u = torch.empty(H, hd, device="meta")
    s0 = torch.empty(B, H, hd, hd, device="meta")
    a, (out, state) = analyze_program(wkv_ops.wkv, *x, u, s0)
    assert out.shape == (B, S, H, hd) and state.shape == (B, H, hd, hd)
    flops, nbytes = wkv.work(*x, u, s0)
    assert flops == 7 * hd * hd * B * H * S == a.flops
    assert nbytes == 4 * (5 * B * S * H * hd + H * hd + 2 * B * H * hd * hd)
    assert a.op_counts["wkv"] == 1 and a.hbm_bytes == nbytes


def test_kernels_still_refuse_other_devices():
    q = torch.empty(1, 4, 2, 16)
    with pytest.raises((ValueError, RuntimeError)):
        flash_ops.flash_attention(q.to("meta").requires_grad_(True),
                                  q.to("meta"), q.to("meta"))


# ----------------------------------------------------------------------------
# Roofline on the H100's constants
# ----------------------------------------------------------------------------

def test_h100_constants():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12 and LINK_BW == 450e9


def test_roofline_terms_and_dominant():
    r = Roofline(flops=989e12, bytes_hbm=6.7e12, bytes_collective=450e9,
                 model_flops=2 * 989e12, chips=4)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(1.0)
    assert r.dominant == "memory" and r.bound_time == pytest.approx(2.0)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(2 / 2 / 4)
    d = r.to_dict()
    assert set(d) == {"flops_per_device", "hbm_bytes_per_device",
                      "collective_bytes_per_device", "model_flops", "chips",
                      "t_compute_s", "t_memory_s", "t_collective_s",
                      "dominant", "useful_flops_fraction",
                      "roofline_fraction"}


def test_roofline_without_a_collective_count():
    r = Roofline(flops=989e12 * 3, bytes_hbm=3.35e12, bytes_collective=None,
                 model_flops=989e12, chips=1)
    assert r.t_collective is None
    assert r.dominant == "compute" and r.bound_time == pytest.approx(3.0)
    assert r.to_dict()["t_collective_s"] is None
    assert Roofline(0, 0, None, 0, 1).roofline_fraction == 0.0


# ----------------------------------------------------------------------------
# every smoke config's gradient against the JAX package's HLO count
# ----------------------------------------------------------------------------

EXACT = ["qwen3-1.7b|None|256", "qwen3-1.7b|full|256", "qwen3-1.7b|None|2048",
         "minicpm-2b|None|256", "phi3.5-moe-42b-a6.6b|None|256",
         "internlm2-1.8b|None|256", "arctic-480b|None|256",
         "whisper-base|None|256", "qwen2-vl-2b|None|256"]


@pytest.mark.parametrize("case", EXACT)
def test_grad_dot_flops_equal_jax(grad_flops, case):
    port, jax_flops = grad_flops[case]
    assert port.flops == jax_flops
    assert port.warnings == [] and port.flops > 0


def test_grad_dot_flops_at_the_chunked_path(grad_flops):
    port, _ = grad_flops[f"qwen3-1.7b|None|{CHUNKED_S}"]
    assert port.flops == 15_502_147_584
    # 8 x 2 query x key blocks, 2 products each, 2 layers, and twice that
    # in the backward
    assert port.op_counts["aten.bmm"] == 3 * 8 * 2 * 2 * 2


def test_gemma3_jax_counts_two_layers_of_attention(grad_flops):
    """gemma3 computes attention in each of its L layers, and so does its
    XLA program: a `lax.cond` on the layer kind inside the layer scan
    (repro/models/transformer.py:141-147). `analyze_hlo` builds its call
    graph from calls= / to_apply= / body= / condition= and not from a
    conditional's branch_computations, so each branch (the global and the
    local attention, forward and backward) gets multiplier 1 instead of the
    scan's L trips: it counts 2 of the 6 layers' attention. The port's
    count is the larger by exactly the other L - 2 layers' attention dots
    (6 of 2 B H S^2 hd each: q k^T and p v forward, four in backward)."""
    port, jax_flops = grad_flops[f"gemma3-27b|None|{GRAD_S}"]
    cfg = get_config("gemma3-27b", smoke=True)
    per_layer = 6 * 2 * GRAD_B * cfg.n_heads * GRAD_S ** 2 * cfg.head_dim
    assert port.flops - jax_flops == (cfg.n_layers - 2) * per_layer
    assert port.flops / jax_flops == pytest.approx(1.41026, rel=1e-5)


def test_rwkv6_within_one_outer_product(grad_flops):
    """rwkv6: kv = k^T v is an outer product. XLA lowers one contraction of
    its gradient as a dot ([B, H, hd] by hd, per token and layer); the port
    computes it as a broadcast multiply and a sum, not a dot. JAX's count
    is the larger by exactly that, 0.26 % (stated tolerance 0.3 %)."""
    port, jax_flops = grad_flops[f"rwkv6-7b|None|{GRAD_S}"]
    cfg = get_config("rwkv6-7b", smoke=True)
    hd = cfg.d_model // cfg.n_heads
    assert jax_flops - port.flops == \
        cfg.n_layers * GRAD_S * 2 * GRAD_B * cfg.n_heads * hd * hd
    assert port.flops == pytest.approx(jax_flops, rel=3e-3)


def test_hymba_within_one_outer_product(grad_flops):
    """hymba: the Mamba read-out's gradient has an outer product over the
    tokens (B S rows, d by ssm_state, K = 1). The port's autograd runs it
    as a bmm with K = 1; XLA as a multiply. The port's count is the larger
    by exactly that, 0.08 % (stated tolerance 0.1 %)."""
    port, jax_flops = grad_flops[f"hymba-1.5b|None|{GRAD_S}"]
    cfg = get_config("hymba-1.5b", smoke=True)
    assert port.flops - jax_flops == \
        cfg.n_layers * 2 * GRAD_B * GRAD_S * cfg.d_model * cfg.ssm_state
    assert port.flops == pytest.approx(jax_flops, rel=1e-3)
