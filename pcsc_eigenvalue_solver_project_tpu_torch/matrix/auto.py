"""Automatic sparse-layout selection: ``from_coo(..., layout="auto")``.

The reference dispatches dense/sparse at run time
(reference src/power_method/power_method.hpp:141-147); the dispatch that
matters for speed is between sparse layouts. ``from_coo(..., layout="auto")``
inspects the COO pattern and builds an ``InterleavedDIA`` (banded structure,
kernel B1), a ``SparseGELL`` (anything else, kernel B6), or either inside a
``PermutedOperator`` when a reverse-Cuthill-McKee relabelling (scipy)
uncovers a band or a smaller column footprint. ``suggest_layout`` exposes
the rule and its statistics without building anything.

A symmetric permutation ``P A P^T`` keeps the spectrum, so solvers run in
the permuted domain and only the eigenvector needs the inverse permutation,
which ``PermutedOperator.decode_vec`` applies once per solve.

The decision rule and its constants are the JAX package's
(``matrix/auto.py``), so both pick the same layout for the same pattern.
They were tuned on TPU throughput; whether they suit the H100 is an open
question (PERF.md §7).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .dia import SparseDIA
from .gell import SparseGELL
from .protocol import AbstractMatrix

MAX_DIAGS = 128
MIN_DIA_FILL = 0.20
_CHUNK = 16384
_TILE_ROWS = 128


@dataclasses.dataclass(frozen=True)
class LayoutDecision:
    """Outcome of ``suggest_layout``: the chosen ``kind`` ("dia_il" or
    "gell"), an optional symmetric RCM permutation (new-to-old row order),
    and the pattern statistics the rule used."""
    kind: str
    perm: np.ndarray | None
    stats: dict


def _dia_stats(r, c, n):
    offs = np.unique(c.astype(np.int64) - r.astype(np.int64))
    fill = len(r) / (max(len(offs), 1) * n)
    return len(offs), fill


def _chunk_footprint(r, c, n):
    """Mean distinct 16384-column chunks touched per 128-row tile."""
    tiles = r // _TILE_ROWS
    chunks = c // _CHUNK
    keys = np.unique(tiles.astype(np.int64) * (n // _CHUNK + 2) + chunks)
    n_tiles = max(int(tiles.max()) + 1 if len(tiles) else 1, 1)
    return len(keys) / n_tiles


def _rcm_perm(r, c, n):
    """Reverse-Cuthill-McKee order of the symmetrised pattern."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ones = np.ones(len(r), np.int8)
    a = sp.coo_matrix((ones, (r, c)), shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a + a.T, symmetric_mode=True))


def suggest_layout(row, col, values, shape, *,
                   try_rcm: bool = True) -> LayoutDecision:
    """Pick the layout for a COO pattern: (1) few distinct diagonals with
    adequate fill -> interleaved DIA; (2) else RCM-permute and re-test -> DIA
    with the permutation; (3) else GELL, permuted when RCM cuts the per-tile
    column-chunk footprint by at least a quarter, unpermuted otherwise."""
    n = int(shape[0])
    r = np.asarray(row, np.int64)
    c = np.asarray(col, np.int64)
    stats: dict = {"n": n, "nnz": int(len(r))}

    n_offs, fill = _dia_stats(r, c, n)
    stats["n_diagonals"] = int(n_offs)
    stats["dia_fill"] = float(fill)
    if n_offs <= MAX_DIAGS and fill >= MIN_DIA_FILL:
        return LayoutDecision("dia_il", None, stats)

    if not try_rcm or n < 2 * _TILE_ROWS:
        return LayoutDecision("gell", None, stats)

    perm = _rcm_perm(r, c, n)
    pos = np.empty(n, np.int64)
    pos[perm] = np.arange(n)
    rp, cp = pos[r], pos[c]

    n_offs_p, fill_p = _dia_stats(rp, cp, n)
    stats["n_diagonals_rcm"] = int(n_offs_p)
    stats["dia_fill_rcm"] = float(fill_p)
    if n_offs_p <= MAX_DIAGS and fill_p >= MIN_DIA_FILL:
        return LayoutDecision("dia_il", perm, stats)

    foot = _chunk_footprint(r, c, n)
    foot_p = _chunk_footprint(rp, cp, n)
    stats["chunks_per_tile"] = float(foot)
    stats["chunks_per_tile_rcm"] = float(foot_p)
    if foot_p < 0.75 * foot:
        return LayoutDecision("gell", perm, stats)
    return LayoutDecision("gell", None, stats)


@dataclasses.dataclass(frozen=True)
class PermutedOperator(AbstractMatrix):
    """Symmetrically permuted operator ``P A P^T`` with the permutation
    folded into the vector codec: solvers iterate in the permuted domain and
    ``decode_vec`` restores the original indexing. ``perm`` (new-to-old:
    ``permuted[i] = original[perm[i]]``) and ``inv_perm`` are int64 tensors
    on the inner operator's device."""

    inner: AbstractMatrix
    perm: torch.Tensor
    inv_perm: torch.Tensor

    @property
    def shape(self):
        return self.inner.shape

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    @property
    def is_dense(self):
        return False

    def encode_vec(self, x):
        return self.inner.encode_vec(x[..., self.perm])

    def decode_vec(self, x):
        return self.inner.decode_vec(x)[..., self.inv_perm]

    def matvec(self, x):
        return self.inner.matvec(x)

    def rmatvec(self, x):
        # (P A P^T)^H = P A^H P^T: the same codec around the adjoint core
        return self.inner.rmatvec(x)

    def matmat(self, xs):
        return self.inner.matmat(xs)

    def diagonal(self):
        # in the original domain, like every vector at the API boundary
        return self.inner.diagonal()[self.inv_perm]

    def to_dense(self):
        d = self.inner.to_dense()
        return d[self.inv_perm][:, self.inv_perm]


def from_coo(row, col, values, shape, *, layout: str = "auto", dtype=None,
             tile_rows: int | None = None, try_rcm: bool = True, device=None):
    """Build the operator for COO data on ``device`` (default: the card).

    ``layout``: "auto" (decide from the pattern), "dia_il", "gell", or "csr"
    (``SparseCSR.from_coo``). Returns an ``AbstractMatrix``, possibly a
    ``PermutedOperator`` around the layout of the RCM-permuted matrix. A
    rectangular matrix under "auto" becomes a ``SparseGELL``. Under "gell"
    the data goes straight to ``SparseGELL.from_coo``, which packs card
    tensors where they lie; "auto" reads the pattern on the host (its RCM
    step is scipy's)."""
    from .sparse import SparseCSR

    n_rows, n_cols = map(int, shape)
    if layout == "csr":
        return SparseCSR.from_coo(row, col, values, shape, dtype=dtype, device=device)
    if n_rows != n_cols and layout == "dia_il":
        raise ValueError("from_coo: DIA layout requires a square matrix")
    if layout == "gell" or (n_rows != n_cols and layout == "auto"):
        return SparseGELL.from_coo(row, col, values, shape, dtype=dtype,
                                   tile_rows=tile_rows, device=device)

    r = np.asarray(row, np.int64)
    c = np.asarray(col, np.int64)
    v = np.asarray(values)
    if layout == "auto":
        dec = suggest_layout(r, c, v, shape, try_rcm=try_rcm)
        kind, perm = dec.kind, dec.perm
    elif layout == "dia_il":
        kind, perm = layout, None
    else:
        raise ValueError(f"from_coo: unknown layout {layout!r}")

    if perm is not None:
        pos = np.empty(n_rows, np.int64)
        pos[perm] = np.arange(n_rows)
        r, c = pos[r], pos[c]

    if kind == "dia_il":
        csr = SparseCSR.from_coo(r, c, v, shape, dtype=dtype, device=device)
        m: AbstractMatrix = SparseDIA.from_csr(csr).interleaved()
    else:
        m = SparseGELL.from_coo(r, c, v, shape, dtype=dtype, tile_rows=tile_rows,
                                device=device)
    if perm is None:
        return m
    inv = np.empty(n_rows, np.int64)
    inv[perm] = np.arange(n_rows)
    return PermutedOperator(inner=m, perm=torch.from_numpy(perm.astype(np.int64)).to(m.device),
                            inv_perm=torch.from_numpy(inv).to(m.device))
