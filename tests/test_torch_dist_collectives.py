"""The collectives over the process transport (one gloo process per
member, on the CPU) against the single-process transport: every
collective's results equal to the bit at p = 4 and 5, the link counts
equal (each rank counts its own sends and receives), the straggler's link
at the Lemma-5 minimum, compressed psum's all-gather at a quarter of the
bytes, the card's full-length check at a small length, and a failing rank
failing the run. One spawn per p for the whole module."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.comms import LocalTransport, dist, parity  # noqa: E402

PS = (4, 5)
# chunks of 334 / 251 fp32 elements at p = 4 / 5 (the OptCC chunks), and
# of 251 / 201 in psum: none a whole number of 16-byte vectors
N = 1001
SEED = 3
# small segments, so that every hop stages through host memory in several
SEGMENT_BYTES = 256


def _names(p):
    names = ["psum_fp32", "psum_bf16", "ring", "psum_tree"]
    names += [f"{kind}_{s}" for s in parity.STRAGGLERS if s < p
              for kind in ("optcc", "tree")]
    names += [f"hier_{i}_{o}" for i in parity.hierarchies(p)
              for o in (True, False)]
    return names + ["compressed", "compressed_dyadic"]


CASES = [(p, name) for p in PS for name in _names(p)]


@pytest.fixture(scope="module")
def runs():
    """{p: (LocalTransport suite, [each rank's ProcessTransport suite])},
    every process on one thread, as the local run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for p in PS:
            ranks = dist.spawn(parity.rank_suite, p,
                               (p, N, SEED, "cpu", SEGMENT_BYTES, False))
            local = parity.run_suite(LocalTransport(p),
                                     parity.inputs(p, N, SEED))
            out[p] = (local, ranks)
        return out
    finally:
        torch.set_num_threads(threads)


def _flat(res):
    if isinstance(res, torch.Tensor):
        return [res]
    return [t for r in res for t in _flat(r)]


@pytest.mark.parametrize("p,name", CASES)
def test_process_transport_equals_local_bit_for_bit(runs, p, name):
    local, ranks = runs[p]
    assert set(local) == set(_names(p))
    for rank in range(p):
        want = _flat(local[name]["out"][rank])
        got = _flat(ranks[rank][name]["out"][0])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g.float().numpy(), w.float().numpy()), \
                (name, rank)


@pytest.mark.parametrize("p,name", CASES)
def test_link_counts_equal_local(runs, p, name):
    """Each link's count is taken by its sender and by its receiver, and
    both equal the single-process transport's; a rank counts no link it is
    not on."""
    local, ranks = runs[p]
    for key in ("elems", "bytes"):
        want = local[name][key]
        for s in range(p):
            for d in range(p):
                seen = [ranks[r][name][key][s, d] for r in range(p)]
                assert seen[s] == seen[d] == want[s, d], (key, s, d)
                assert all(v == 0 for r, v in enumerate(seen)
                           if r not in (s, d))


@pytest.mark.parametrize("p", PS)
def test_straggler_link_carries_twice_the_padded_length(runs, p):
    """OptCC flat and as a tree: the straggler sends JAX's padded vector
    (N padded to a multiple of p - 1) once and receives it once."""
    _, ranks = runs[p]
    npad = N + (-N) % (p - 1)
    for s in parity.STRAGGLERS:
        if s >= p:
            continue
        for kind in ("optcc", "tree"):
            elems = ranks[s][f"{kind}_{s}"]["elems"]
            assert elems[s].sum() == npad and elems[:, s].sum() == npad
            assert elems[s].sum() + elems[:, s].sum() == 2 * npad


@pytest.mark.parametrize("p", PS)
def test_compressed_all_gather_moves_a_quarter_of_the_bytes(runs, p):
    """compressed_psum moves psum's fp32 reduce-scatter and an int8
    all-gather: against psum's fp32 all-gather, a quarter of the bytes,
    plus one fp32 scale from each member to each other."""
    local, _ = runs[p]
    c = -(-N // p)
    links = p * (p - 1)
    fp32 = local["psum_fp32"]["bytes"].sum()
    assert fp32 == 2 * links * c * 4          # reduce-scatter + all-gather
    comp = local["compressed"]["bytes"].sum()
    gather = comp - links * c * 4
    assert gather == links * c + links * 4    # int8 shards + fp32 scales
    assert gather - links * 4 == (fp32 - links * c * 4) // 4


def test_full_length_check_runs_on_the_cpu():
    """The card's full-length phase at a small length: psum bf16 to the
    bit, the tree within its limit, on every rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = dist.spawn(parity.full_length, 4,
                           (4, 4099, SEED, "cpu", 1024, 1, 1000))
    finally:
        torch.set_num_threads(threads)
    npad = 4099 + (-4099) % 3
    for rank, res in enumerate(ranks):
        assert res["psum"]["max_abs_err"] == 0.0
        assert res["tree"]["max_abs_err"] < 1e-5
        assert res["tree"]["elems"][1].sum() == (npad if rank in (0, 1)
                                                 else 0)
        assert res["psum"]["hops"] and res["tree"]["hops"]


def test_a_failing_rank_fails_the_run():
    """Rank 3 has no input row (inputs for 3 members in a group of 4) and
    raises while the others wait for its chunks: the run raises (the first
    error reported may be a rank that lost its peer), and nothing hangs."""
    with pytest.raises(Exception, match=r"Process \d terminated"):
        dist.spawn(parity.rank_suite, 4, (3, N, SEED, "cpu", SEGMENT_BYTES,
                                          False))
