"""Fault-tolerant checkpointing of trees of tensors, in the reference's
on-disk layout.

Translated from the reference's ``checkpoint/checkpointer.py``; a
checkpoint written by either side restores on the other:

- ``<dir>/step_%010d/arrays.npz`` holds every leaf under its key path,
  dict keys and sequence indices joined by ``::`` (``params::layers::
  attn::wq``); bfloat16 leaves, which npz cannot hold, are stored as
  their uint16 bits, and ``MANIFEST.json`` keeps each leaf's true dtype
  and shape;
- atomic: written into ``step_%010d.tmp``, the manifest fsynced, then
  renamed, so a crash mid-write never shows a half checkpoint (a
  ``.tmp`` directory is never listed);
- keep-k retention, and an optional background thread that writes while
  training goes on (the copy to host memory happens in ``save``);
- :meth:`Checkpointer.restore` fills a template's structure, casting each
  leaf to the template's dtype and shape, onto the template leaf's device
  or a given one; with ``shardings`` (``parallel.sharding.Sharding`` objects)
  each rank keeps its shard of every full leaf, whatever mesh wrote the
  checkpoint (elastic restore: leaves are stored whole);
- :func:`install_sigterm_handler` checkpoints and exits cleanly on
  preemption.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_path, unflatten

_SEP = "::"
#: dtypes npz stores as they are
_NPZ_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
               "int8", "uint64", "uint32", "uint16", "uint8", "bool")


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_host(x) -> tuple:
    """(numpy array as npz stores it, the true dtype's name).  Always a
    copy: the train step updates its state in place, so an array that
    aliased a CPU leaf would change under a background write."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy(), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.array(x, copy=True)
    return x, str(x.dtype)


def _structure(tree) -> str:
    """The tree's containers, leaves as ``*`` (for the manifest)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return "(" + ", ".join(_structure(x) for x in tree) + ")"
    return "*"


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, use_async: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._async = use_async
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        if use_async:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self):
        out = []
        for n in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", n)
            if m and os.path.exists(os.path.join(self.dir, n,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Copy ``tree`` to host memory now, then write it (in the
        background thread unless ``blocking`` or the checkpointer is
        synchronous)."""
        if self._error:
            raise self._error
        flat = {_key(p): _to_host(x) for p, x in leaves_with_path(tree)}
        host = (flat, _structure(tree))
        if self._async and not blocking:
            self._q.put((step, host))
        else:
            self._write(step, host)

    def wait(self):
        if self._async:
            self._q.join()
        if self._error:
            raise self._error

    def _drain(self):
        while True:
            step, host = self._q.get()
            try:
                self._write(step, host)
            except Exception as e:  # noqa: BLE001 — raised by save / wait
                self._error = e
            finally:
                # drop the host copy now, not when the next save arrives
                del host
                self._q.task_done()

    def _write(self, step: int, host):
        flat, structure = host
        tmp = self._step_dir(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: v for k, (v, _) in flat.items()})
        manifest = {
            "step": step,
            "treedef": structure,
            "leaves": {k: {"shape": list(v.shape), "dtype": dt}
                       for k, (v, dt) in flat.items()},
        }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Any:
        """A tree with ``template``'s structure, each leaf read from the
        checkpoint of ``step`` (default: the latest), cast to the template
        leaf's dtype and shape (the full shape) and placed on ``device``
        (default: the template leaf's device).  With ``shardings``, a
        matching tree of ``Sharding`` objects, each leaf is cut to this rank's
        shard of the new mesh: the elastic path.  A leaf missing from the
        checkpoint raises ``KeyError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with open(os.path.join(self._step_dir(step), "MANIFEST.json")) as f:
            manifest = json.load(f)
        out = []
        with np.load(os.path.join(self._step_dir(step), "arrays.npz")) as data:
            for path, ref in leaves_with_path(template):
                key = _key(path)
                if key not in data:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                true = manifest["leaves"].get(key, {}).get("dtype")
                t = torch.from_numpy(np.ascontiguousarray(arr))
                if true == "bfloat16" and arr.dtype == np.uint16:
                    t = t.view(torch.bfloat16)
                elif true not in (None, *_NPZ_DTYPES):
                    raise TypeError(f"leaf {key}: cannot read dtype {true}")
                dst = device if device is not None else ref.device
                out.append(t.to(ref.dtype).reshape(ref.shape).to(dst))
        if shardings is not None:
            out = [s.local(x) for x, s in zip(out, leaves(shardings))]
        return unflatten(template, out)


def install_sigterm_handler(save_fn: Callable[[], None]):
    """Preemption handling: checkpoint then exit 0 (clean restart)."""

    def handler(signum, frame):  # noqa: ARG001
        save_fn()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, handler)
    return handler
