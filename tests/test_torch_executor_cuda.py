"""The schedule executor on the card against the same executor on the CPU,
bit for bit. Imports no JAX (the card's machine has none): run it there with
`python -m pytest -q -m cuda tests/test_torch_executor_cuda.py`."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import executor, model  # noqa: E402
from repro_torch.core.planner import make_plan  # noqa: E402

SEED = 23


@pytest.mark.cuda
def test_cuda_execute_matches_cpu():
    """The card's executor equals the CPU's to the bit, fp32 and bf16, on a
    schedule of each algorithm family."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    specs = ((model.BandwidthProfile.single_straggler(8, 2.0, 3),
              ("ring", "optcc", "dbtree", "torus2d")),
             (model.BandwidthProfile.multi_straggler(16, [2.0, 1.5]),
              ("optcc",)),
             (model.BandwidthProfile.single_straggler(16, 2.0, 1, g=4),
              ("optcc", "hierarchical")))
    n = (1 << 16) + 1
    for prof, names in specs:
        for name in names:
            sched = make_plan(prof, n, 16, algo=name).schedule
            gen = torch.Generator().manual_seed(SEED)
            x = torch.randn((prof.p, n), generator=gen)
            for xt in (x, x.to(torch.bfloat16)):
                cpu = executor.execute(sched, xt)
                card = executor.execute(sched, xt.cuda())
                assert card.device.type == "cuda"
                assert torch.equal(card.cpu(), cpu), (name, xt.dtype)
