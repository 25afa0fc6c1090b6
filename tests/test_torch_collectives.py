"""The port's collectives over the single-process transport: AllReduce
semantics, chunk ownership, the straggler's link volume, the tree's chunk
rows, and the JAX collectives themselves (4 forced host devices, one
subprocess) on the same input: ring and OptCC, the OptCC tree,
hierarchical_psum and compressed_psum."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax_reference as drv  # noqa: E402
from repro_torch.comms import (LocalTransport,  # noqa: E402
                               compressed_psum, hierarchical_psum,
                               optcc_allreduce, optcc_allreduce_tree, psum,
                               psum_tree, ring_all_gather, ring_allreduce,
                               ring_reduce_scatter)

REPO = pathlib.Path(__file__).resolve().parent.parent
# sums of p fp32 terms in another association than x.sum(0)
SUM_TOL = dict(rtol=1e-6, atol=1e-5)


def _x(p, n, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (p, n)).astype(np.float32))


@pytest.mark.parametrize("p", [3, 4, 8])
@pytest.mark.parametrize("n", [7, 1000, 1001])
def test_allreduce_equals_sum_on_every_member(p, n):
    x = _x(p, n)
    want = x.sum(0).expand(p, n).numpy()
    tr = LocalTransport(p)
    for s in range(p):
        np.testing.assert_allclose(optcc_allreduce(x, s, tr).numpy(), want,
                                   **SUM_TOL)
    np.testing.assert_allclose(psum(x).numpy(), want[0], **SUM_TOL)
    if n % p == 0:
        np.testing.assert_allclose(ring_allreduce(x, tr).numpy(), want,
                                   **SUM_TOL)


@pytest.mark.parametrize("p", [3, 4, 8])
def test_reduce_scatter_chunk_ownership(p):
    x = _x(p, 10 * p, seed=p)
    chunks = x.sum(0).reshape(p, -1)
    rs = ring_reduce_scatter(x, LocalTransport(p))
    for i in range(p):
        np.testing.assert_allclose(rs[i].numpy(), chunks[(i + 1) % p].numpy(),
                                   **SUM_TOL)
    ag = ring_all_gather(rs, LocalTransport(p))
    np.testing.assert_allclose(ag.numpy(), x.sum(0).expand(p, -1).numpy(),
                               **SUM_TOL)


@pytest.mark.parametrize("p", [3, 4, 8])
@pytest.mark.parametrize("n", [7, 1000, 1001])
def test_straggler_link_carries_twice_the_padded_length(p, n):
    npad = n + (-n) % (p - 1)
    x = _x(p, n)
    for s in range(p):
        tr = LocalTransport(p)
        optcc_allreduce(x, s, tr)
        assert tr.link_load(s) == 2 * npad          # Lemma 5's minimum
        assert tr.link_elems[s].sum() == npad       # out once
        assert tr.link_elems[:, s].sum() == npad    # back once
    ring_tr = LocalTransport(p)
    if n % p == 0:
        ring_allreduce(x, ring_tr)
        # the symmetric ring: 2 (p-1)/p n per member, each direction
        assert ring_tr.link_load(0) == 2 * 2 * (p - 1) * n // p


def test_tree_forms_sum_each_leaf():
    p = 4
    x = _x(p, 611)
    members = [[x[i, :600].reshape(20, 30), x[i, 600:607],
                x[i, 607:611].to(torch.bfloat16)] for i in range(p)]
    want = [x[:, :600].sum(0).reshape(20, 30), x[:, 600:607].sum(0),
            x[:, 607:611].to(torch.bfloat16).float().sum(0)]
    tr = LocalTransport(p)
    for got in (optcc_allreduce_tree(iter(members), 2, tr),
                psum_tree(iter(members), tr)):
        assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                          torch.float32] or \
            got[2].dtype == torch.bfloat16
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), w.numpy(),
                                       rtol=1e-2 if g.dtype ==
                                       torch.bfloat16 else 1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        optcc_allreduce_tree(iter(members[:3]), 0, tr)


class _SpyTransport(LocalTransport):
    """A LocalTransport that records every buffer it adds rows of."""

    def __init__(self, p):
        super().__init__(p)
        self.buffers = []

    def accumulate(self, buf, moves, length=None):
        self.buffers.append((tuple(buf.shape), buf.stride(), buf.data_ptr(),
                             buf.element_size(), length))
        super().accumulate(buf, moves, length)


@pytest.mark.parametrize("n", [611, 1001, 1889110016 % 10007])
def test_tree_chunks_are_whole_16_byte_vectors(n):
    """The tree keeps JAX's chunks - the vector padded to a multiple of
    p - 1, cut into p - 1 chunks of c - and gives each chunk its own row of
    whole 16-byte vectors: every row the pair form adds starts 16-byte
    aligned, and the straggler's link carries JAX's padded vector out and
    back once."""
    p = 4
    x = _x(p, n)
    tr = _SpyTransport(p)
    got = optcc_allreduce_tree(iter([[x[i]] for i in range(p)]), 1, tr)
    np.testing.assert_allclose(got[0].numpy(), x.sum(0).numpy(), **SUM_TOL)
    npad = n + (-n) % (p - 1)
    c = npad // (p - 1)
    assert tr.buffers
    for shape, stride, ptr, itemsize, length in tr.buffers:
        assert length == c                          # JAX's chunk boundaries
        assert shape == (p, p - 1, -(-c // 4) * 4)  # a row per chunk
        assert (stride[1] * itemsize) % 16 == 0 and ptr % 16 == 0
    assert tr.link_load(1) == 2 * npad


def _tree_members(x, n):
    return [drv.tree_leaves(x[i], n) for i in range(x.shape[0])]


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "collectives.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "jax_reference.py"),
         "collectives", str(out)], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(np.load(out))


def test_ring_matches_jax_per_member(jax_results):
    x = torch.from_numpy(jax_results["x"][:, :drv.RING_N])
    tr = LocalTransport(drv.P)
    np.testing.assert_allclose(ring_allreduce(x, tr).numpy(),
                               jax_results["ring_allreduce"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ring_reduce_scatter(x, tr).numpy(),
                               jax_results["ring_reduce_scatter"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("straggler", drv.STRAGGLERS)
def test_optcc_matches_jax_per_member(jax_results, straggler):
    x = torch.from_numpy(jax_results["x"])
    assert np.array_equal(jax_results["x"], drv.collective_input())
    got = optcc_allreduce(x, straggler, LocalTransport(drv.P))
    np.testing.assert_allclose(got.numpy(), jax_results[f"optcc_{straggler}"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", drv.TREE_NS)
@pytest.mark.parametrize("straggler", drv.STRAGGLERS)
def test_tree_matches_jax_bit_for_bit(jax_results, n, straggler):
    """optcc_allreduce_tree equals JAX's to the bit: the same chunks, the
    same additions (fp32 leaves, a bf16 leaf cast to fp32 and back)."""
    x = torch.from_numpy(jax_results["tree_x"][:, :n])
    got = optcc_allreduce_tree(iter(_tree_members(x, n)), straggler,
                               LocalTransport(drv.P))
    assert [g.dtype for g in got] == [torch.float32, torch.float32,
                                      torch.bfloat16]
    for i, g in enumerate(got):
        want = jax_results[f"tree_{n}_{straggler}_{i}"]
        assert all(np.array_equal(g.float().numpy(), w) for w in want), i


@pytest.mark.parametrize("outer", [True, False])
def test_hierarchical_matches_jax_bit_for_bit(jax_results, outer):
    """hierarchical_psum on the 2 x 2 ('outer', 'inner') mesh: psum over
    each inner pair, then (with outer) over each outer pair."""
    x = torch.from_numpy(jax_results["x"])
    got = hierarchical_psum(x, drv.INNER, LocalTransport(drv.P), outer)
    assert np.array_equal(got.numpy(), jax_results[f"hier_{outer}"])


def test_compressed_matches_jax_on_dyadic_inputs_bit_for_bit(jax_results):
    """Inputs whose sums are exact in fp32 in any order: what is left to
    compare is the quantization, and it agrees to the bit."""
    x = torch.from_numpy(drv.dyadic_input())
    got, err = compressed_psum(x, LocalTransport(drv.P))
    assert np.array_equal(got.numpy(), jax_results["compressed_dyadic"])
    assert np.array_equal(err.numpy(), jax_results["compressed_dyadic_error"])


def test_compressed_matches_jax_within_one_quantum(jax_results):
    """Seeded normal inputs with an error-feedback term: psum_scatter's
    additions may associate otherwise, so a quantized value may round to
    its neighbour: within one quantum (the shard's scale) per element."""
    p, n = drv.P, drv.COLLECTIVE_N
    x = torch.from_numpy(jax_results["x"])
    error = torch.from_numpy(drv.error_input())
    got, err = compressed_psum(x, LocalTransport(p), error)
    c = -(-n // p)
    shards = torch.nn.functional.pad(x + error, (0, p * c - n)).sum(0)
    quantum = (shards.view(p, c).abs().amax(1) / 127).repeat_interleave(c)
    quantum = quantum[:n].numpy()
    for g, w in ((got, jax_results["compressed_normal"]),
                 (err, jax_results["compressed_normal_error"])):
        assert np.all(np.abs(g.numpy() - w) <= quantum)
    np.testing.assert_allclose(got.numpy(), (x + error).sum(0).expand(
        p, n).numpy(), atol=float(quantum.max()), rtol=0)
