"""Checkpoint/resume for the VAMP state.

The reference has no resume mechanism - its per-iteration xhat/r1 binary
dumps are checkpoint-shaped but cannot restore a run (SURVEY.md section 5).
Here the full VampState pytree (including the prior and PRNG key) is saved
each iteration as a flat .npz, so a killed run restarts exactly where it
stopped. Writes are atomic (tmp file + rename) so a crash mid-write never
corrupts the latest checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import jax
import numpy as np


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, it: int) -> str:
        return os.path.join(self.directory, f"vamp_state_{it:06d}.npz")

    def save(self, state, it: int) -> str:
        from sgvamp.parallel.multihost import fetch_global

        leaves, treedef = jax.tree_util.tree_flatten(state)
        arrays = {f"leaf_{i}": fetch_global(x) for i, x in enumerate(leaves)}
        # Structure fingerprint: restoring into a different configuration
        # with the same leaf count must fail loudly, not silently permute
        # fields.
        arrays["__treedef__"] = np.asarray(str(treedef))
        path = self._path(it)
        if jax.process_count() > 1 and jax.process_index() != 0:
            # every process participates in the fetch collectives above;
            # only process 0 touches the filesystem
            return path
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        self._gc()
        return path

    def _existing(self):
        pat = re.compile(r"vamp_state_(\d+)\.npz$")
        out = []
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, name)))
        return sorted(out)

    def _gc(self) -> None:
        existing = self._existing()
        for _, path in existing[: max(0, len(existing) - self.keep)]:
            os.remove(path)

    def restore_latest(self, template) -> Optional[Tuple[object, int]]:
        """Restore the newest checkpoint into the structure of `template`.

        Returns (state, iteration) or None if no checkpoint exists.
        """
        existing = self._existing()
        if not existing:
            return None
        it, path = existing[-1]
        with np.load(path) as data:
            n_leaves = sum(1 for f in data.files if f.startswith("leaf_"))
            leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
            saved_treedef = (str(data["__treedef__"])
                             if "__treedef__" in data.files else None)
        t_leaves, treedef = jax.tree_util.tree_flatten(template)
        if len(leaves) != len(t_leaves):
            raise ValueError(
                f"checkpoint {path} has {len(leaves)} state leaves but the "
                f"current configuration expects {len(t_leaves)} - it was "
                "written by an incompatible version/configuration"
            )
        if saved_treedef is not None and saved_treedef != str(treedef):
            raise ValueError(
                f"checkpoint {path} was written with a different state "
                f"structure (treedef mismatch) - refusing to restore into "
                "permuted fields"
            )
        for i, (x, t) in enumerate(zip(leaves, t_leaves)):
            ts = getattr(t, "shape", None)
            if ts is not None and tuple(np.shape(x)) != tuple(ts):
                raise ValueError(
                    f"checkpoint {path} leaf {i} has shape {np.shape(x)} but "
                    f"the current configuration expects {tuple(ts)}"
                )
        state = jax.tree_util.tree_unflatten(treedef, leaves)
        # Restore on-device with the template's dtypes/shardings.
        state = jax.tree_util.tree_map(
            lambda t, x: jax.device_put(np.asarray(x).astype(t.dtype), t.sharding)
            if hasattr(t, "sharding") else x,
            template, state,
        )
        return state, it
