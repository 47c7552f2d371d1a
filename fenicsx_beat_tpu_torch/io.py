"""Checkpoints of dof arrays over time.

Port of the checkpoint half of ``fenicsx_beat_tpu/io.py`` (lines 38-100):
:class:`CheckpointWriter` gathers ``(t, values)`` snapshots and writes them
with the mesh arrays to one compressed ``.npz``; :func:`load_checkpoint`
reads one back as :class:`CheckpointData`.  The layout is the JAX
package's (``times``, ``values`` as float32, ``coords``, ``cells``,
``cell_type`` by name), so each package reads the other's files.  The
VTU writer and the mesh readers and writers are not ported (ROADMAP A14).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np

from .mesh import Mesh

__all__ = ["CheckpointWriter", "CheckpointData", "load_checkpoint"]


class CheckpointData(NamedTuple):
    times: np.ndarray  # [nt]
    values: np.ndarray  # [nt, ndofs]
    coords: np.ndarray
    cells: np.ndarray
    cell_type: str


@dataclass
class CheckpointWriter:
    """Accumulates ``(t, dof-array)`` snapshots; :meth:`save` writes one npz."""

    path: str | Path
    mesh: Mesh

    def __post_init__(self):
        self._times: list[float] = []
        self._values: list[np.ndarray] = []

    def write(self, t: float, values: np.ndarray) -> None:
        self._times.append(float(t))
        self._values.append(np.asarray(values, dtype=np.float32).copy())

    def save(self) -> Path:
        path = Path(self.path).with_suffix(".npz")
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            times=np.asarray(self._times),
            values=np.stack(self._values) if self._values else np.zeros((0, 0)),
            coords=self.mesh.coords,
            cells=self.mesh.cells,
            cell_type=self.mesh.cell_type.name,
        )
        return path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.save()
        return False


def load_checkpoint(path: str | Path) -> CheckpointData:
    with np.load(Path(path).with_suffix(".npz"), allow_pickle=False) as f:
        return CheckpointData(
            times=f["times"],
            values=f["values"],
            coords=f["coords"],
            cells=f["cells"],
            cell_type=str(f["cell_type"]),
        )
