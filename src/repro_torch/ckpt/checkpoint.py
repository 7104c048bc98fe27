"""Checkpointing with atomic manifests and async writes (counterpart of
repro/ckpt/checkpoint.py), in the reference's layout:

    <dir>/step_<N>.tmp/ -> atomically renamed to <dir>/step_<N>/
    leaf files: leaf_<i>.npy ;  manifest.json: step + every leaf's key,
    file, shape and dtype. A LATEST file points at the newest complete
    step.

Leaves are written in the reference's order with its keys
(:func:`repro_torch.tree.tree_items`: ``.params/...``, ``.opt/...``,
``.step``), bfloat16 as its ``uint16`` bit pattern, so that each package
restores the other's checkpoint of the same training state. On restore
the port views those bits as ``torch.bfloat16`` (it needs no
``ml_dtypes``) and puts each leaf on the device of the matching leaf of
``like``. Writes happen on a background thread (training continues;
``wait()`` joins before the next save or exit); the device-to-host copy
is made before the thread starts. Unlike the reference's, a restore
first joins the manager's own write in flight: a failure right after a
save (a large checkpoint still being written) restores that save
instead of finding no checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_items, tree_unflatten


def _to_host(t) -> Tuple[np.ndarray, str]:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        # np.save can't represent bfloat16: store the bit pattern
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype_name: str,
               device: torch.device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.array(arr, order="C").view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        self.wait()
        host_items = [(k, *_to_host(v)) for k, v in tree_items(state)]

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (key, arr, dtype_name) in enumerate(host_items):
                fname = f"leaf_{i}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append(
                    {"key": key, "file": fname,
                     "shape": list(arr.shape), "dtype": dtype_name})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "LATEST.tmp"),
                       os.path.join(self.dir, "LATEST"))
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def available_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        """The newest complete step, after this manager's write in flight
        (if any) has landed."""
        self.wait()
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            step = int(f.read().strip())
        if step in self.available_steps():
            return step
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """Restore into the structure (and the leaves' devices) of
        ``like``."""
        self.wait()
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        items = list(tree_items(like))
        if len(items) != len(manifest["leaves"]):
            raise ValueError("checkpoint/state structure mismatch")
        leaves = []
        for (key, target), meta in zip(items, manifest["leaves"]):
            if meta["key"] != key:
                raise ValueError(
                    f"leaf order mismatch: {meta['key']} != {key}")
            arr = np.load(os.path.join(final, meta["file"]))
            if list(arr.shape) != list(getattr(target, "shape",
                                               np.shape(target))):
                raise ValueError(f"shape mismatch at {key}")
            device = (target.device if isinstance(target, torch.Tensor)
                      else torch.device("cpu"))
            leaves.append(_from_host(arr, meta["dtype"], device))
        return tree_unflatten(like, leaves)

    def restore_latest(self, like: Any) -> Optional[Tuple[Any, int]]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, like), step
