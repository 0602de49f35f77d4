"""Train-state checkpoints in the JAX package's format.

The counterpart of ``repro.train.checkpoint.Checkpointer``: one ``.npz``
per step holding every leaf under its "/"-joined path, plus a JSON sidecar
with the step and the caller's extras (data-pipeline state, arch, loss).
The port writes the JAX package's key layout (``params/blocks/pos<i>/...``
stacked over ``n_periods``, ``opt/m``, ``opt/v``, ``opt/step``), so a
checkpoint written by either package restores into the other.  bfloat16
leaves are written as float32 (exact; the JAX package casts them back on
restore), and the bfloat16 leaves the JAX package writes are read bit for
bit.

``save`` writes to a temporary name and renames atomically, in a
background thread unless ``async_save=False``, and keeps the last ``keep``
checkpoints, so a crash mid-save never corrupts the latest restorable one.

A sharded state (DTensor leaves) is saved whole: every rank of the mesh
joins each leaf's ``full_tensor()`` and rank 0 writes.  ``restore`` with
``placements`` places each leaf on any mesh (the elastic restore), whatever
layout it was saved from.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch import convert
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_items


class Checkpointer:
    def __init__(self, directory: str, cfg: ArchConfig, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        # copy to host now; the write may run in the background
        flat = convert.flatten_paths(
            convert.train_state_to_numpy(state, self.cfg))
        if dist.is_initialized() and dist.get_rank() != 0:
            return  # rank 0 writes the gathered state
        if self._thread is not None:
            self._thread.join()  # never overlap two writes

        def write():
            tmp = self.dir / f".tmp_step_{step:08d}.npz"
            final = self.dir / f"step_{step:08d}.npz"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
            meta = {"step": step, **(extra or {})}
            mtmp = self.dir / f".tmp_step_{step:08d}.json"
            with open(mtmp, "w") as f:
                f.write(json.dumps(meta))
                f.flush()
                os.fsync(f.fileno())
            os.replace(mtmp, self.dir / f"step_{step:08d}.json")
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*.npz"))
        for old in ckpts[:-self.keep]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*.npz"))
        if not ckpts:
            return None
        return int(ckpts[-1].stem.split("_")[1])

    def restore(self, step: Optional[int], template: Dict[str, Any],
                placements: Optional[Dict[str, Any]] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The state saved at ``step`` (the latest when None), each leaf on
        the device and in the dtype of ``template``'s leaf at the same place
        (a state of the same config, e.g. a fresh ``init_train_state``),
        and the sidecar's metadata.  ``placements``, a tree like the
        state's whose leaves have ``.mesh`` and ``.placements``
        (``launch.sharding.to_shardings``), places every leaf on its mesh
        as a DTensor."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self.dir / f"step_{step:08d}.npz") as z:
            tree = convert.unflatten_paths({k: z[k] for k in z.files})
        like = dict(tree_items(template))
        where = dict(tree_items(placements)) if placements else {}

        def leaf(path, a):
            t = like[path]
            out = convert.numpy_to_tensor(a, t.dtype, t.device)
            lay = where.get(path)
            if lay is None:
                return out
            from torch.distributed.tensor import distribute_tensor
            return distribute_tensor(out, lay.mesh, list(lay.placements))

        state = {"params": convert.from_jax_layout(
                     tree["params"], self.cfg,
                     lambda p, a: leaf(("params",) + p, a)),
                 "opt": {k: convert.from_jax_layout(
                             tree["opt"][k], self.cfg,
                             lambda p, a, k=k: leaf(("opt", k) + p, a))
                         for k in ("m", "v")}}
        state["opt"]["step"] = int(tree["opt"]["step"])
        if "ef" in template:
            state["ef"] = convert.from_jax_layout(
                tree["ef"], self.cfg, lambda p, a: leaf(("ef",) + p, a))
        meta = json.loads((self.dir / f"step_{step:08d}.json").read_text())
        return state, meta
