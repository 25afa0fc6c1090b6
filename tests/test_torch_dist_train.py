"""The training launcher over `--transport gloo` (one process per DP
member, on the CPU) against the single-process run: qwen3-smoke through
healthy -> degraded -> repaired steps gives the same losses, grad norms and
final parameters to the bit, with the same thread count in every process;
checkpoints come from rank 0 alone; the step's `compression` flag changes
nothing; elastic rescale across processes is refused."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.comms import LocalTransport  # noqa: E402
from repro_torch.comms.fault import FaultState  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.train import init_train_state, make_dp_failover_step  # noqa: E402

ARGV = ["--smoke", "--device", "cpu", "--dp", "4", "--steps", "6",
        "--fail-at", "2", "--repair-at", "4", "--straggler", "1",
        "--log-every", "1"]
FIELDS = ("step", "loss", "grad_norm", "sync", "algo", "dp")


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The local and the gloo run, one thread in every process (the
    spawned ranks take the parent's count); the gloo run saves step_6."""
    ckpt = tmp_path_factory.mktemp("gloo_ckpt")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        local = main(ARGV)
        gloo = main(ARGV + ["--transport", "gloo", "--ckpt-dir", str(ckpt),
                            "--ckpt-every", "6"])
    finally:
        torch.set_num_threads(threads)
    return local, gloo, ckpt


def test_gloo_run_equals_local_run_bit_for_bit(both_runs):
    (state, log), (gstate, glog), _ = both_runs
    assert [r["sync"] for r in glog] == ["psum"] * 2 + ["optcc"] * 2 + \
        ["psum"] * 2
    assert [{k: r[k] for k in FIELDS} for r in glog] == \
        [{k: r[k] for k in FIELDS} for r in log]
    assert gstate.step == state.step == 6 and gstate.opt_state is None
    assert sorted(gstate.params) == sorted(state.params)
    for k, v in state.params.items():
        assert gstate.params[k].dtype == v.dtype
        assert torch.equal(gstate.params[k], v), k


def test_gloo_checkpoint_is_rank_zeros_final_state(both_runs):
    """Rank 0 writes the checkpoint, in the unchanged format: restoring it
    gives the run's final parameters."""
    from repro_torch.checkpoint import restore
    (state, _), (gstate, glog), ckpt = both_runs
    assert latest_step(str(ckpt)) == 6
    assert [ev["op"] for r in glog for ev in r["checkpoint"]] == ["save"]
    model = build_model(get_config("qwen3-1.7b", smoke=True))
    template = init_train_state(model, AdamWConfig(weight_decay=0.01),
                                device="cpu")
    restored, meta = restore(str(ckpt), template)
    assert int(meta["step"]) == 6
    for k, v in gstate.params.items():
        assert torch.equal(restored.params[k], v), k


def test_gloo_refuses_elastic_rescale():
    with pytest.raises(ValueError, match="--lose-node-at needs --transport "
                                         "local"):
        main(ARGV + ["--transport", "gloo", "--lose-node-at", "3"])


@pytest.mark.parametrize("degraded", [False, True])
def test_compression_flag_changes_nothing(degraded):
    """make_dp_failover_step's `compression` is accepted and not read, as
    in JAX: two steps with it on equal two with it off, to the bit."""
    model = build_model(get_config("qwen3-1.7b", smoke=True))
    opt = AdamWConfig(weight_decay=0.01)
    data = SyntheticLM(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=16, global_batch=8))
    fault = FaultState(4, 1, 1.5) if degraded else FaultState(4)
    finals = []
    for compression in (False, True):
        step = make_dp_failover_step(model, LocalTransport(4), opt,
                                     constant(1e-3), fault,
                                     compression=compression)
        state = init_train_state(model, opt, device="cpu")
        losses = []
        for i in range(2):
            batch = {k: torch.as_tensor(v) for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        finals.append((losses, state.params))
    (l0, p0), (l1, p1) = finals
    assert l0 == l1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
