"""The work of the hand-written kernels, for the dry-run's counts.

Each kernel module has one function that gives a call's bytes and
operations from its shapes and dtypes (``segment_sum.work``,
``flash_attention.work``, ``decode_attention.work``, ``ssd.work``,
``gmm.work``; the backward's with ``backward=True``): each input read
once and each output written once, the products the call must do.
``chip_smoke.py``'s bounds and the dry-run's counts
(``launch.counts.Counts``) both read them, so the two count the same
work.

A kernel launches through raw pointers, so no dispatch mode sees it.
While a count is open (:func:`counting`), each wrapper records its call's
work here (:func:`record`) where it launches its kernel, and on a CPU
tensor it runs its plain version under :func:`uncounted`, which keeps the
plain version's own ops out of the count: a CPU run and a card run count
the same kernel work.

The open counts are a plain list, not a context variable: a CUDA backward
runs on autograd's own thread, which does not see the caller's context.
"""
from __future__ import annotations

import contextlib
from typing import List

#: the open counts, innermost last (``launch.counts.Counts`` pushes
#: itself while it is entered)
OPEN: List = []


def counting() -> bool:
    """Whether a count is open: a wrapper computes its work only then."""
    return bool(OPEN)


def record(name: str, nbytes: float, ops: float) -> None:
    """Add one call of kernel ``name`` moving ``nbytes`` and doing ``ops``
    operations to every open count."""
    for c in OPEN:
        c.add_kernel(name, nbytes, ops)


@contextlib.contextmanager
def uncounted():
    """Ops dispatched inside are outside every open count: a kernel's
    plain version on the CPU (its work is the kernel's, recorded by
    :func:`record`), or a wrapper's read of the data its work depends on
    (the decode kernel's valid positions)."""
    with contextlib.ExitStack() as stack:
        for c in list(OPEN):
            stack.enter_context(c.excluded())
        yield
