"""Score-only alignment of one (large) pair over a device mesh.

The counterpart of the JAX package's ``dist/sharded.py``
``score_pair_sharded`` (``sharded.py:394-449``), which routes to the
collective sweep by default. Only that route is ported: the JAX package's
host-orchestrated superstep engine (``_sharded_score``, ``_band_compute*``)
and its ``engine=`` switch are a TPU dispatch workaround that the
collective kernel (K10) replaces, and the port has no engine switch
(ROADMAP queue 1, "Not ported, on purpose"). Over a mesh of several
processes the outputs are replicated on every process, as the JAX
package's ``out_specs P()`` outputs are.
"""
from __future__ import annotations

from anyseq_tpu_torch.core.types import Mode
from anyseq_tpu_torch.dist import collective
from anyseq_tpu_torch.dist.mesh import Mesh, check_mesh


def score_pair_sharded(query, subject, mode, sc, mesh: Mesh,
                       axis: str = "sp", start_gap: bool = False,
                       band_rows: int | None = None):
    """Score one pair with its subject sharded over every device of
    `mesh`: a mesh of more than one axis is flattened into one sp ring (a
    single pair has nothing for the other axes to do). Returns the
    outputs of ``linmem.score_rows`` (affine: with ``last_col_e`` and
    ``last_row_f``) on this process's first device of the mesh, on every
    process; combine them with ``linmem.extract_end``. ``band_rows``: the
    collective sweep's band height (``collective.launch_pair``)."""
    mode = Mode.parse(mode)
    if check_mesh(mesh).axis_names != (axis,):
        mesh = mesh.reshape(-1, (axis,))
    return collective.score_pair_collective(query, subject, mode, sc, mesh,
                                            axis=axis, band_rows=band_rows,
                                            start_gap=start_gap)
