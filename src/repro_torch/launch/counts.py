"""The dry-run's counts of one step: collective bytes by op type, flops and
bytes accessed.

The counterpart of the reference's ``launch/hlo.py``.  The reference reads
them off the compiled, partitioned HLO of a step it never runs; the port
has no compiler, so it counts one run of the step on one rank
(``launch.specs.lower_cell``), with the same dict shapes:

- :func:`collective_bytes` sums the per-rank *result* bytes of every
  collective the step calls, by the reference's op names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``, ``collective-permute``
  for a receive), with ``_counts`` and ``_total``.  A ``TorchDispatchMode``
  sees each ``torch.distributed`` call as its ``c10d`` op, whatever
  called it (``parallel.sharding``'s gathers, scatters and all-reduces,
  ``optim.adamw``'s norm, the vocabulary-parallel log-sum-exp,
  ``parallel.pipeline``'s send / receive) and whatever the backend.
- :func:`cost_dict` gives ``{"flops", "bytes accessed"}``.  Flops are
  ``torch.utils.flop_counter.FlopCounterMode``'s count (matrix products,
  attention, convolutions: elementwise ops count nothing) plus each
  hand-written kernel's own count.  Bytes accessed are the sum, over
  every dispatched op, of its input and output bytes, views and
  allocations excluded, plus each kernel's own bytes: XLA's definition op
  by op, without its fusion, so the figure is larger than the
  reference's for the same step.

The kernels launch through raw pointers, which no dispatch mode sees:
each wrapper records its call's bytes and operations while a count is
open (``kernels.work``), from the same formulas as ``chip_smoke.py``'s
bounds, and on a CPU tensor keeps its plain version's ops out of the
count, so a CPU run counts what a card run does.

On a fake process group (``launch.dryrun_lib.fake_group``) collectives
run but move nothing; under :class:`Counts` each one's output is filled
as if every rank held this rank's values (an all-gather repeats the
input, a reduce-scatter takes this rank's block, an all-to-all passes
the input on, a receive reads zeros; an all-reduce leaves the input), so
no uninitialised memory enters the step.  Other backends are left as
they are.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import work

#: c10d op -> the reference's collective op name
COLLECTIVES = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}

#: ops that allocate without touching memory
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "resize_", "set_"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _group(args):
    """The process group among a c10d op's arguments (its first script
    object)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a)
    raise ValueError("a c10d op without a process group")


def _fill_fake(name: str, args, pg) -> None:
    """The output of collective ``name`` on a fake group, as if every rank
    held this rank's values."""
    if name == "_allgather_base_":
        out, inp = args[0], args[1]
        out.view(pg.size(), *inp.shape).copy_(inp.unsqueeze(0).expand(
            pg.size(), *inp.shape))
    elif name == "allgather_":
        for t in args[0][0]:
            t.copy_(args[1][0])
    elif name == "_reduce_scatter_base_":
        out, inp = args[0], args[1]
        out.copy_(inp.view(pg.size(), *out.shape)[pg.rank()])
    elif name == "reduce_scatter_":
        args[0][0].copy_(args[1][0][pg.rank()])
    elif name == "alltoall_base_":
        args[0].copy_(args[1])
    elif name == "alltoall_":
        for o, i in zip(args[0], args[1]):
            o.copy_(i)
    elif name in ("recv_", "recv_any_source_"):
        for t in args[0]:
            t.zero_()


class _Mode(TorchDispatchMode):
    def __init__(self, counts: "Counts"):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.counts
        if c._skip:
            return out
        if func.namespace == "c10d":
            name = func._opname
            op = COLLECTIVES.get(name)
            if op is not None:
                import torch.distributed as dist
                pg = _group(args)
                if dist.get_backend(pg) == "fake":
                    _fill_fake(name, args, pg)
                c.collective[op] += _nbytes(args[0])
                c.collective_n[op] += 1
            return out
        if not func.is_view and func._opname not in _NO_BYTES:
            c.op_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


class Counts:
    """One run's counts, open while entered (``with Counts() as c:``):
    collectives by op type, FlopCounterMode's flops, the dispatched ops'
    bytes and each kernel's calls, bytes and operations
    (:meth:`add_kernel`, from ``kernels.work.record``)."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self.collective: Dict[str, int] = collections.defaultdict(int)
        self.collective_n: Dict[str, int] = collections.defaultdict(int)
        self.op_bytes = 0
        self.kernels: Dict[str, list] = {}
        self._flops = FlopCounterMode(display=False)
        self._excluded_flops = 0
        self._skip = 0
        self._mode = _Mode(self)

    def __enter__(self):
        self._flops.__enter__()
        self._mode.__enter__()
        work.OPEN.append(self)
        return self

    def __exit__(self, *exc):
        work.OPEN.remove(self)
        self._mode.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def add_kernel(self, name: str, nbytes: float, ops: float) -> None:
        k = self.kernels.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += int(nbytes)
        k[2] += int(ops)

    @contextlib.contextmanager
    def excluded(self):
        """Ops dispatched inside are not counted (a kernel's plain version,
        whose work the kernel's record stands for)."""
        before = self._flops.get_total_flops()
        self._skip += 1
        try:
            yield
        finally:
            self._skip -= 1
            self._excluded_flops += self._flops.get_total_flops() - before

    @property
    def flops(self) -> int:
        return (self._flops.get_total_flops() - self._excluded_flops
                + sum(k[2] for k in self.kernels.values()))

    @property
    def bytes_accessed(self) -> int:
        return self.op_bytes + sum(k[1] for k in self.kernels.values())


def _counts(x) -> Counts:
    return x if isinstance(x, Counts) else x.counts


def cost_dict(run) -> Dict[str, float]:
    """``{"flops", "bytes accessed"}`` of one counted run (a
    :class:`Counts`, or a ``launch.specs.CellRun``)."""
    c = _counts(run)
    return {"flops": float(c.flops), "bytes accessed": float(c.bytes_accessed)}


def collective_bytes(run) -> Dict[str, int]:
    """The per-rank result bytes of every collective of one counted run,
    by op type, with ``_counts`` (collectives by op type) and ``_total``:
    the reference's ``collective_bytes`` dict."""
    c = _counts(run)
    out = dict(c.collective)
    out["_counts"] = dict(c.collective_n)
    out["_total"] = sum(c.collective.values())
    return out


def kernel_counts(run) -> Dict[str, dict]:
    """{kernel: {"calls", "bytes", "ops"}} of one counted run."""
    return {k: {"calls": n, "bytes": b, "ops": o}
            for k, (n, b, o) in sorted(_counts(run).kernels.items())}
