"""Op counts of an eager program: the port's counterpart of
`repro/roofline/hlo_parse.py`.

The port has no HLO. Its program is the sequence of aten ops that eager
PyTorch dispatches, so `analyze_program(fn, *args)` runs fn once under a
`TorchDispatchMode`, normally on `meta` tensors (shapes and dtypes, no
storage, no arithmetic), and counts what that sequence does:

  * FLOPs: hlo_parse's rule for a dot, 2 * prod(result) * K, for every
    mm, bmm, addmm and baddbmm (`torch.utils.flop_counter`'s registered
    formulas give the same numbers for these ops), plus the work that a
    hand-written kernel records with `record` where the path reaches it on
    `meta` (flash attention and wkv; their rules live in their
    `kernel.py`): the dry run counts what runs on the card, the kernel;
  * HBM bytes: the input and output bytes of every op that is not a view.
    Eager PyTorch fuses nothing, so every op reads its inputs from device
    memory and writes its outputs there. XLA's count (hlo_parse: fusion
    internals touch no HBM) is of another program, fused, and is not
    comparable with this one;
  * collectives: none, on one device;
  * per-op calls and FLOPs (`top_flop_ops`);
  * peak_live_bytes: the largest sum of live storage bytes during the run,
    the arguments' storage included. Each storage that an argument holds
    or an op creates is counted until a weakref finalizer sees it freed,
    as the caching allocator sees a block freed: the counterpart of
    memory_analysis's sizes, held on the card to
    `torch.cuda.max_memory_allocated` of the same program.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
# dot ops -> the index of the left operand, whose last dim is K
DOT_OPS = {_aten.mm.default: 0, _aten.bmm.default: 0,
           _aten.addmm.default: 1, _aten.baddbmm.default: 1}
# ops that allocate without moving a byte
FREE_OPS = {_aten.empty.memory_format, _aten.empty_strided.default,
            _aten.empty_like.default}
# matrix products this count leaves out (as hlo_parse counts only dots):
# named in `warnings` when the program runs one
UNCOUNTED = ("aten.mv", "aten.addmv", "aten.dot", "aten.vdot",
             "aten.convolution", "aten._scaled_dot_product")

_ACTIVE: list = []          # the analyses that are counting, innermost last


@dataclasses.dataclass
class OpAnalysis:
    """hlo_parse.HloAnalysis's fields where they have a meaning here (no
    trip counts: an eager program has no loops of its own), the calls and
    FLOPs per op, and the peak of live storage."""
    flops: int = 0              # integers, exact at any size
    hbm_bytes: int = 0
    collective_bytes: int = 0
    collective_by_kind: dict = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    op_counts: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    warnings: list = dataclasses.field(default_factory=list)


def _tensors(obj):
    """The tensors in a nest of dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Live:
    """Live storage bytes and their peak. A storage is counted once, from
    the first tensor seen on it until it is freed."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.seen: set = set()

    def add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.seen:
            return
        n = st.nbytes()
        self.seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n: int) -> None:
        self.seen.discard(key)
        self.live -= n


class _Counter(TorchDispatchMode):
    def __init__(self, result: OpAnalysis, live: _Live):
        super().__init__()
        self.result = result
        self.live = live
        self.calls = collections.Counter()
        self.flops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        self.calls[name] += 1
        outs = list(_tensors(out))
        for t in outs:
            self.live.add(t)
        if func in DOT_OPS:
            k = args[DOT_OPS[func]].shape[-1]
            f = 2 * out.numel() * k
            self.flops[name] += f
            self.result.flops += f
        elif name.startswith(UNCOUNTED) and \
                f"{name}: not counted" not in self.result.warnings:
            self.result.warnings.append(f"{name}: not counted")
        if not func.is_view and func not in FREE_OPS:
            self.result.hbm_bytes += sum(
                _nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in outs)
        return out


def record(name: str, flops: int, nbytes: int) -> None:
    """Add a kernel's work (one call) to the innermost analysis running;
    a no-op outside `analyze_program`."""
    if not _ACTIVE:
        return
    counter = _ACTIVE[-1]
    counter.calls[name] += 1
    counter.flops[name] += flops
    counter.result.flops += flops
    counter.result.hbm_bytes += nbytes


def analyze_program(fn, *args, **kwargs) -> tuple[OpAnalysis, object]:
    """Run fn(*args, **kwargs) once, counting its ops; returns (analysis,
    what fn returned)."""
    result = OpAnalysis()
    live = _Live()
    for t in _tensors((args, kwargs)):
        live.add(t)
    counter = _Counter(result, live)
    _ACTIVE.append(counter)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.pop()
    result.op_counts = dict(sorted(counter.calls.items()))
    result.flops_by_op = dict(sorted(counter.flops.items()))
    result.peak_live_bytes = live.peak
    return result, out


def top_flop_ops(analysis: OpAnalysis, k: int = 15
                 ) -> list[tuple[float, str, int]]:
    """The k largest FLOP contributors: (flops, op, calls)."""
    return heapq.nlargest(k, ((f, op, analysis.op_counts.get(op, 0))
                              for op, f in analysis.flops_by_op.items()))


def meta_like(tree):
    """A nest of dicts, lists and tuples with each tensor replaced by an
    empty `meta` tensor of its shape and dtype (requires_grad kept): a
    program's arguments for `analyze_program` without their memory."""
    if isinstance(tree, torch.Tensor):
        t = torch.empty(tree.shape, dtype=tree.dtype, device="meta")
        return t.requires_grad_(tree.requires_grad)
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    return tree


def scaled(analysis: OpAnalysis, n: int) -> OpAnalysis:
    """The counts of n runs of the same program (peak unchanged)."""
    return dataclasses.replace(
        analysis, flops=analysis.flops * n, hbm_bytes=analysis.hbm_bytes * n,
        op_counts={k: v * n for k, v in analysis.op_counts.items()},
        flops_by_op={k: v * n for k, v in analysis.flops_by_op.items()},
        warnings=list(analysis.warnings))


def combined(*parts: OpAnalysis) -> OpAnalysis:
    """The counts of programs run one after another; the peak is the
    largest of theirs (each was traced with the same arguments live)."""
    calls, flops = collections.Counter(), collections.Counter()
    for a in parts:
        calls.update(a.op_counts)
        flops.update(a.flops_by_op)
    return OpAnalysis(
        flops=sum(a.flops for a in parts),
        hbm_bytes=sum(a.hbm_bytes for a in parts),
        op_counts=dict(sorted(calls.items())),
        flops_by_op=dict(sorted(flops.items())),
        peak_live_bytes=max(a.peak_live_bytes for a in parts),
        warnings=sorted({w for a in parts for w in a.warnings}))
