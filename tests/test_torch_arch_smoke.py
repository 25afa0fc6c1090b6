"""tests/test_arch_smoke.py for the port, over all ten ARCH_IDS: the full
configs' published shapes (and that each builds a model), and on each
smoke config a finite loss and finite gradients, one training step with
finite metrics and parameters - through `make_gspmd_train_step` on a
one-device mesh, as tests/test_arch_smoke.py trains, and through the DP
step (2 members, psum) - and the shapes of a prefill and
a decode step. Also the launchers' `--set key=value` config overrides:
parsed as the JAX dry run parses them (`repro/launch/dryrun.py`, run in a
subprocess with its `run_cell` stubbed), applied by `cfg.replace` (an
unknown field raises) and printed."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comms import LocalTransport  # noqa: E402
from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 parse_overrides)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.sharding import Mesh  # noqa: E402
from repro_torch.train import (init_train_state,  # noqa: E402
                               make_dp_failover_step,
                               make_gspmd_train_step)

REPO = pathlib.Path(__file__).resolve().parent.parent
SPEC = {  # tests/test_arch_smoke.py's table
    "qwen3-1.7b": (28, 2048, 16, 8, 6144, 151936),
    "gemma3-27b": (62, 5376, 32, 16, 21504, 262144),
    "minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
    "internlm2-1.8b": (24, 2048, 16, 8, 8192, 92544),
    "rwkv6-7b": (32, 4096, 64, 64, 14336, 65536),
    "arctic-480b": (35, 7168, 56, 8, 4864, 32000),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
    "hymba-1.5b": (32, 1600, 25, 5, 5504, 32001),
    "whisper-base": (6, 512, 8, 8, 2048, 51865),
    "qwen2-vl-2b": (28, 1536, 12, 2, 8960, 151936),
}


def make_batch(cfg, B=2, S=24, seed=0):
    """tests/test_arch_smoke.py's batch: tokens as labels; whisper's
    frames and qwen2-vl's patch prefix standard normal."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).long()
    batch = {"tokens": toks, "labels": toks.clone()}
    if cfg.family == "whisper":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_matches_spec(arch):
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == SPEC[arch]
    if arch == "arctic-480b":
        assert cfg.n_experts == 128 and cfg.top_k == 2 and cfg.moe_dense_ff
    if arch == "phi3.5-moe-42b-a6.6b":
        assert cfg.n_experts == 16 and cfg.top_k == 2
    if arch == "qwen3-1.7b":
        assert cfg.qk_norm
    if arch == "gemma3-27b":
        assert cfg.global_every == 6  # 5 local : 1 global
    if arch == "hymba-1.5b":
        assert cfg.ssm_state == 16
    if arch == "qwen2-vl-2b":
        assert cfg.mrope
    if arch == "whisper-base":
        assert cfg.encoder_layers == 6
    assert build_model(cfg).cfg is cfg        # builds, allocating nothing


@pytest.mark.parametrize("kind", ["gspmd", "dp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch, kind):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    batch = make_batch(cfg)
    params = model.init(0, "cpu")
    for t in params.values():
        t.requires_grad_(True)
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert np.isfinite(float(loss.detach())), f"{arch}: loss={loss}"
    assert all(torch.isfinite(g).all() for g in grads), arch

    opt = AdamWConfig()
    state = init_train_state(model, opt, device="cpu")
    if kind == "gspmd":
        step = make_gspmd_train_step(model, Mesh((1,), ("data",)), opt,
                                     constant(1e-3))
    else:
        step = make_dp_failover_step(model, LocalTransport(2), opt,
                                     constant(1e-3), FaultState(2))
    state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    for k, v in state.params.items():
        assert torch.isfinite(v.detach().float()).all(), (arch, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode(arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    B, S = 2, 16
    batch = make_batch(cfg, B, S)
    batch.pop("labels")
    batch.pop("prefix_embeds", None)      # serving takes text prompts
    params = model.init(0, "cpu")
    with torch.no_grad():
        logits, _ = model.prefill(params, batch)
        assert logits.shape == (B, cfg.vocab_size)
        cache = model.init_cache(B, S + 4, "cpu")
        lg, _ = model.decode_step(params, cache, batch["tokens"][:, :1], S)
    assert lg.shape == (B, cfg.vocab_size)
    assert torch.isfinite(lg).all(), arch


# --set values of every kind dryrun's parse gives: int, float, bool,
# string, a value holding "=", an empty value
SET_ARGS = ["n_layers=2", "capacity_factor=8.0", "rope_theta=1e4",
            "fsdp=False", "qk_norm=True", "remat=full", "name=a=b",
            "moment_dtype="]


def test_set_parses_as_the_jax_dry_run():
    code = (
        "import json, sys\n"
        "from repro.launch import dryrun\n"
        "seen = []\n"
        "def run_cell(*a, overrides=None, **kw):\n"
        "    seen.append(overrides)\n"
        "    return {'status': 'skipped'}\n"
        "dryrun.run_cell = run_cell\n"
        "sys.argv = ['dryrun', '--arch', 'qwen3-1.7b', '--shape',\n"
        "            sys.argv[1]] + ['--set=' + a for a in sys.argv[2:]]\n"
        "dryrun.main()\n"
        "print(json.dumps(seen[0]))\n")
    from repro.configs import SHAPES
    proc = subprocess.run(
        [sys.executable, "-c", code, SHAPES[0].name] + SET_ARGS,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src"),
                 JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])
    ours = parse_overrides(SET_ARGS)
    assert ours == theirs
    assert [type(v) for v in ours.values()] == \
        [type(v) for v in theirs.values()]
    assert ours["n_layers"] == 2 and ours["fsdp"] is False


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_set_unknown_field_raises(launcher):
    main = serve_main if launcher == "serve" else train_main
    with pytest.raises(TypeError, match="no_such_field"):
        main(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device",
              "cpu", "--set", "no_such_field=1"])


def test_set_cuts_depth_and_is_printed(capsys):
    tokens, log = serve_main(["--arch", "arctic-480b", "--smoke", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "8",
                              "--new-tokens", "3", "--set", "n_layers=1",
                              "--set", "capacity_factor=2.0"])
    out = capsys.readouterr().out
    assert "config overrides: {'n_layers': 1, 'capacity_factor': 2.0}" in out
    assert log["n_layers"] == 1 and log["overrides"] == {
        "n_layers": 1, "capacity_factor": 2.0}
    assert tokens.shape == (2, 3)
    full = build_model(get_config("arctic-480b", smoke=True)).init(0, "cpu")
    assert log["params"] < sum(v.numel() for v in full.values())
