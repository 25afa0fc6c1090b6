"""The port's single-device GSPMD training step, `cfg.remat` and the
sharding rules against the JAX package.

- remat "full" and "dots" leave the loss and every gradient equal to the
  bit (qwen3-smoke, phi3.5-moe-smoke through the MoE block, and qwen3 at a
  chunked-attention length), and "dots" recomputes no matrix product;
- one `make_gspmd_train_step` step of each of the ten smoke configs, and
  of qwen3-smoke with 4 microbatches and remat="full", from JAX's init on
  the same batch against JAX's step (tests/jax_reference.py gspmd_step,
  one subprocess with 512 forced host devices);
- tests/test_train_substrate.py's microbatched-against-plain check;
- `param_pspec` of every leaf of the ten FULL configs, and `batch_spec`,
  `input_specs` and `cache_specs` of every admitted (arch, shape cell)
  pair, on both production meshes with fsdp on and off, equal to JAX's;
  the shape cells field-equal;
- `constrain_batch` returns its input and the loss calls it on each
  layer's carry, as JAX's model code does;
- a mesh of more than one device and an unknown remat raise;
- on a card (marked `cuda`): a step on the card against the CPU's.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro import configs as jax_configs  # noqa: E402
from repro_torch.configs import (ARCH_IDS, LONG_CONTEXT_ARCHS,  # noqa: E402
                                 SHAPES, cell_is_applicable, get_config)
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import (cache_specs, input_specs,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, init_state  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.sharding import Mesh, eval_shape  # noqa: E402
from repro_torch.train import (TrainState, batch_spec,  # noqa: E402
                               init_train_state, make_gspmd_train_step,
                               param_pspec, shardings_for_params)

REPO = pathlib.Path(__file__).resolve().parent.parent
ONE_DEVICE = Mesh((1,), ("data",))
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4   # fp32, as tests/test_torch_model.py
# a gradient leaf's norm-wise limit: the sum of two fp32 runs' errors.
# whisper-smoke's are worse conditioned: on this batch the port's fp32
# gradients sit up to 2.28e-3 of a leaf's norm from a float64 run and
# JAX's up to 1.96e-3 (tools/fp32_conditioning.py --arch whisper-base
# --gspmd-batch --jax)
GRAD_LIMIT = {"whisper-base": 5e-3}
# the share of a leaf's parameters that may part by more than 1e-4 after
# one step (AdamW sign flips): 1 % for whisper-smoke, as chip_smoke.py
# holds the poorly conditioned smoke configs' card runs
FLIP_SHARE = {"whisper-base": 1e-2}
B1 = AdamWConfig().b1


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "gspmd.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"),
         "gspmd_step", str(out)], capture_output=True, text=True, env=env,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = dict(np.load(out))
    res["specs"] = json.loads(str(res["specs"]))
    return res


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(cfg, init: dict, batch: dict):
    params = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    loss = build_model(cfg).loss(params, batch)
    return loss, torch.autograd.grad(loss, list(params.values()))


# (arch, batch, sequence): the smoke batch, and a sequence past the
# 1024-key threshold of chunked attention
REMAT_CASES = [("qwen3-1.7b", 2, 24), ("phi3.5-moe-42b-a6.6b", 2, 24),
               ("qwen3-1.7b", 1, 1040)]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch,B,S", REMAT_CASES)
def test_remat_is_bit_equal(arch, B, S, remat):
    """Checkpointing recomputes the same forward on the same inputs, and
    autograd's graph is the same, so the loss and gradients are equal to
    the bit. (Deterministic algorithms on: the CPU embedding backward's
    parallel accumulation is not, from 2 x 1040 tokens, even between two
    runs without remat.)"""
    cfg = get_config(arch, smoke=True)
    toks = torch.from_numpy(np.random.default_rng(S).integers(
        0, cfg.vocab_size, (B, S))).long()
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    init = build_model(cfg).init(0, "cpu")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        loss, grads = _loss_and_grads(cfg, init, batch)
        rloss, rgrads = _loss_and_grads(cfg.replace(remat=remat), init,
                                        batch)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(rloss, loss)
    for key, a, b in zip(init, rgrads, grads):
        assert torch.equal(a, b), key


def test_dots_saves_every_product():
    """remat="dots" keeps the products' outputs and recomputes only the
    rest: a step does the matrix-product FLOPs of no remat; "full"
    recomputes each block's forward products too."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config("qwen3-1.7b", smoke=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24))).long()
    batch = {"tokens": toks, "labels": toks}
    init = build_model(cfg).init(0, "cpu")
    flops = {}
    for remat in ("none", "full", "dots"):
        with FlopCounterMode(display=False) as counter:
            _loss_and_grads(cfg.replace(remat=remat), init, batch)
        flops[remat] = counter.get_total_flops()
    assert flops["dots"] == flops["none"] < flops["full"]


def _port_step(res, case):
    arch, nmb, remat = drv.GSPMD_CASES[case]
    cfg = get_config(arch, smoke=True)
    if remat:
        cfg = cfg.replace(remat=remat)
    opt = AdamWConfig(weight_decay=0.01)
    params = params_from_numpy(
        {k[len(case) + 6:]: v for k, v in res.items()
         if k.startswith(f"{case}/init/")}, "cpu")
    state = TrainState(params, init_state(params, opt), 0)
    step = make_gspmd_train_step(build_model(cfg), ONE_DEVICE, opt,
                                 constant(drv.GSPMD_LR),
                                 num_microbatches=nmb)
    state, metrics = step(state, _torch_batch(drv.gspmd_batch(cfg)))
    assert state.step == 1
    return state, metrics


@pytest.mark.parametrize("case", list(drv.GSPMD_CASES))
def test_gspmd_step_matches_jax(jax_run, case):
    """The loss; the gradients, as AdamW's first moments after one step
    (0.1 x the clipped gradient), norm-wise per leaf; the parameters to
    AdamW's sign-flip bound (2 lr: its per-element normalisation turns an
    fp32 error in a gradient element near 0 into an update of the other
    sign; few elements do)."""
    state, m = _port_step(jax_run, case)
    arch = drv.GSPMD_CASES[case][0]
    assert float(m["loss"]) == pytest.approx(
        float(jax_run[f"{case}/loss"]), rel=LOSS_TOL)
    limit = GRAD_LIMIT.get(arch, 2 * GRAD_TOL)
    assert float(m["grad_norm"]) == pytest.approx(
        float(jax_run[f"{case}/grad_norm"]), rel=limit)
    assert float(m["lr"]) == float(jax_run[f"{case}/lr"])
    assert m["grad_seconds"] > 0 and m["update_seconds"] > 0
    assert sorted(state.opt_state["mu"]) == sorted(
        k[len(case) + 4:] for k in jax_run if k.startswith(f"{case}/mu/"))
    for key, mu in state.opt_state["mu"].items():
        want = jax_run[f"{case}/mu/{key}"] / (1 - B1)
        gap = np.linalg.norm(mu.numpy() / (1 - B1) - want)
        assert gap <= limit * np.linalg.norm(want), (key, gap)
    for key, v in state.params.items():
        gap = np.abs(v.detach().numpy() - jax_run[f"{case}/params/{key}"])
        assert gap.max() <= 2 * drv.GSPMD_LR, (key, gap.max())
        assert (gap > 1e-4).sum() <= FLIP_SHARE.get(arch, 1e-3) * gap.size, \
            key


TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                   param_dtype="float32", compute_dtype="float32",
                   logits_chunk=32)      # tests/test_train_substrate.py's


def test_microbatched_step_matches_plain():
    """tests/test_train_substrate.py's check, at its limits."""
    model = build_model(TINY)
    opt = AdamWConfig(weight_decay=0.0, clip_norm=0.0)
    data = SyntheticLM(DataConfig(vocab_size=256, seq_len=32,
                                  global_batch=8))
    b = {k: torch.from_numpy(v).long() for k, v in data.batch(0).items()}
    s1 = init_train_state(model, opt, seed=1, device="cpu")
    s2 = init_train_state(model, opt, seed=1, device="cpu")
    plain = make_gspmd_train_step(model, ONE_DEVICE, opt, constant(1e-3))
    micro = make_gspmd_train_step(model, ONE_DEVICE, opt, constant(1e-3),
                                  num_microbatches=4)
    s1, m1 = plain(s1, b)
    s2, m2 = micro(s2, b)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    d = max(float((s1.params[k] - s2.params[k]).detach().abs().max())
            for k in s1.params)
    assert d < 2e-5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspec_matches_jax(jax_run, arch):
    """Every leaf of the FULL config, its shape and dtype taken from the
    port's init on fake tensors (nothing allocated), on both production
    meshes, fsdp on and off."""
    specs = jax_run["specs"]
    cfg = get_config(arch)
    leaves = eval_shape(build_model(cfg).init, 0, "cpu")
    assert {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
            for k, v in leaves.items()} == specs["leaf_shapes"][arch]
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for fsdp in (True, False):
            c = cfg.replace(fsdp=fsdp)
            want = specs["params"][f"{arch}|{multi}|{fsdp}"]
            got = {k: drv.spec_json(param_pspec(k, v, c, mesh))
                   for k, v in leaves.items()}
            assert got == want, (multi, fsdp)
            shardings = shardings_for_params(leaves, c, mesh)
            assert {k: drv.spec_json(s.spec)
                    for k, s in shardings.items()} == want
            assert all(s.mesh is mesh for s in shardings.values())


def _records(tree: dict) -> dict:
    return {k: [list(v.shape), str(v.dtype).removeprefix("torch."),
                drv.spec_json(v.sharding.spec if v.sharding else None)]
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match_jax(jax_run, arch):
    specs = jax_run["specs"]
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        assert drv.spec_json(batch_spec(mesh)) == \
            specs["batch_spec"][str(multi)]
        for shape in SHAPES:
            key = f"{arch}|{shape.name}|{multi}"
            admitted = cell_is_applicable(arch, shape)[0]
            assert admitted == (key in specs["inputs"]), key
            if not admitted:
                continue
            assert _records(input_specs(arch, shape, mesh)) == \
                specs["inputs"][key], key
            if shape.kind == "decode":
                got = cache_specs(get_config(arch), mesh,
                                  shape.global_batch, shape.seq_len)
                assert _records(got) == specs["caches"][key], key


def test_shardctx_returns_its_input():
    """The port holds no sharded tensors: `constrain_batch` returns the
    tensor it was given, whatever its rank and dtype."""
    from repro_torch.models import shardctx
    for x in (torch.ones(2), torch.ones(2, 3, dtype=torch.bfloat16),
              torch.zeros(4, 3, 5, dtype=torch.long)):
        assert shardctx.constrain_batch(x) is x


@pytest.mark.parametrize("arch,module", [
    ("qwen3-1.7b", "transformer"), ("phi3.5-moe-42b-a6.6b", "transformer"),
    ("hymba-1.5b", "hymba"), ("rwkv6-7b", "rwkv6"),
    ("whisper-base", "whisper")])
def test_constrain_batch_on_each_layer(arch, module, monkeypatch):
    """The loss calls `constrain_batch` where JAX's model code does: on
    each layer's carry (whisper: each encoder and each decoder layer's)."""
    import importlib
    from repro_torch.models import shardctx
    mod = importlib.import_module(f"repro_torch.models.{module}")
    seen = []

    def counted(t):
        seen.append(tuple(t.shape))
        return shardctx.constrain_batch(t)

    monkeypatch.setattr(mod, "constrain_batch", counted)
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    loss = model.loss(model.init(0, "cpu"),
                      _torch_batch(drv.gspmd_batch(cfg, B=2)))
    assert bool(torch.isfinite(loss))
    assert len(seen) == cfg.n_layers + cfg.encoder_layers
    assert all(s[0] == 2 for s in seen)


def test_shape_cells_match_jax():
    assert [vars(c) for c in SHAPES] == \
        [vars(c) for c in jax_configs.SHAPES]
    assert LONG_CONTEXT_ARCHS == jax_configs.LONG_CONTEXT_ARCHS
    for arch in ARCH_IDS:
        for ours, theirs in zip(SHAPES, jax_configs.SHAPES):
            assert cell_is_applicable(arch, ours) == \
                jax_configs.cell_is_applicable(arch, theirs)


@pytest.mark.parametrize("mesh", [make_production_mesh(),
                                  make_production_mesh(multi_pod=True),
                                  Mesh((2,), ("data",))],
                         ids=["16x16", "2x16x16", "2"])
def test_mesh_of_more_than_one_device_raises(mesh):
    model = build_model(get_config("qwen3-1.7b", smoke=True))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_gspmd_train_step(model, mesh, AdamWConfig(), constant(1e-3))


def test_unknown_remat_raises():
    cfg = get_config("qwen3-1.7b", smoke=True).replace(remat="selective")
    model = build_model(cfg)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="remat 'selective'"):
        model.loss(model.init(0, "cpu"), {"tokens": toks, "labels": toks})


@pytest.mark.cuda
@pytest.mark.parametrize("nmb", [1, 4])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_cuda_gspmd_step_matches_cpu(remat, nmb):
    """One step of qwen3-smoke on the card against the CPU's from the same
    parameters and batch, TF32 off: the loss, the gradients (first
    moments) norm-wise per leaf, the parameters to AdamW's sign-flip
    bound (the embedding backward's atomics are not deterministic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = get_config("qwen3-1.7b", smoke=True).replace(remat=remat)
    model = build_model(cfg)
    opt = AdamWConfig(weight_decay=0.01)
    init = model.init(0, "cpu")
    batch = _torch_batch(drv.gspmd_batch(cfg))
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    try:
        for dev in ("cuda", "cpu"):
            params = {k: v.clone().to(dev) for k, v in init.items()}
            step = make_gspmd_train_step(model, ONE_DEVICE, opt,
                                         constant(drv.GSPMD_LR),
                                         num_microbatches=nmb)
            state, m = step(TrainState(params, init_state(params, opt), 0),
                            {k: v.to(dev) for k, v in batch.items()})
            runs.append((float(m["loss"]),
                         {k: v.detach().cpu() for k, v in
                          state.params.items()},
                         {k: v.cpu() for k, v in
                          state.opt_state["mu"].items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    (card_loss, card_p, card_mu), (cpu_loss, cpu_p, cpu_mu) = runs
    assert card_loss == pytest.approx(cpu_loss, rel=LOSS_TOL)
    for key in cpu_p:
        gap = float((card_mu[key] - cpu_mu[key]).norm())
        assert gap <= 2 * GRAD_TOL * float(cpu_mu[key].norm()), key
        diff = (card_p[key] - cpu_p[key]).abs()
        assert float(diff.max()) <= 2 * drv.GSPMD_LR, key
        assert int((diff > 1e-4).sum()) <= 1e-2 * diff.numel(), key
