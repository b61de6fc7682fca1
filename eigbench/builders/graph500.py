"""Graph 500's Kronecker graph (the specification's ``kronecker_generator.m``)
as the program serves it: the adjacency matrix of the simple undirected
graph, unit values, packed where it was made by ``SparseGELL.from_coo``.

The generator, transcribed on the device, ``EDGE_CHUNK`` edges at a time:
``M = edgefactor 2^scale`` edges, drawn i.i.d.; for each of the ``scale``
bits of an edge, ``i_bit = rand > A + B`` and ``j_bit = rand > (C / (1 -
(A + B)) if i_bit else A / (A + B))``, with ``rand`` in float64 as MATLAB's;
then one random permutation of the vertex labels. The specification's
shuffle of the edge list leaves i.i.d. edges i.i.d.: they come in random
order already.

Graph 500's kernels ignore self-loops and repeated edges, so the operator is
the simple graph: each edge ``{u, v}``, ``u != v``, stored once as ``(u, v)``
and once as ``(v, u)``. Entries keep the place of their first occurrence in
the generated order, and each chunk of them is shuffled, as the
specification shuffles its edge list, so the pack sorts a real edge list.
Repeats are found by sorting a piece of whole rows (about ``PIECE``
entries) at a time, so no sort spans all entries and the generator's peak
stays below the pack's.

The graph is fixed by the configuration's ``graph_seed``: the run's seed
draws only the start vectors. ``raw`` makes the same entries again for the
reference, once a process."""

from __future__ import annotations

import functools

import torch

from eigbench import traffic

EDGE_CHUNK = 1 << 26
PIECE = 1 << 27
CHECKED_SCALE = 26  # the scale whose entry count the configuration states


def size(cfg: dict) -> int:
    return 2 ** cfg["scale"]


def edges(cfg: dict, device):
    """The generated edges, a chunk at a time: ``(u, v)`` int64 tensors of
    the permuted labels, self-loops left out."""
    scale = cfg["scale"]
    m = cfg["edgefactor"] << scale
    a, b, c = cfg["abc"]
    # the threshold of j_bit, indexed by i_bit
    j_cut = torch.tensor([a / (a + b), c / (1 - (a + b))], dtype=torch.float64, device=device)
    labels = torch.randperm(2 ** scale, device=device,
                            generator=traffic.generator(cfg["graph_seed"], traffic.OPERATOR, -1,
                                                        device))
    for k, start in enumerate(range(0, m, EDGE_CHUNK)):
        gen = traffic.generator(cfg["graph_seed"], traffic.OPERATOR, k, device)
        count = min(EDGE_CHUNK, m - start)
        i = torch.zeros(count, dtype=torch.int64, device=device)
        j = torch.zeros(count, dtype=torch.int64, device=device)
        for bit in range(scale):
            i_bit = torch.rand(count, generator=gen, dtype=torch.float64, device=device) > a + b
            j_bit = (torch.rand(count, generator=gen, dtype=torch.float64, device=device)
                     > j_cut[i_bit.long()])
            i |= i_bit.long() << bit
            j |= j_bit.long() << bit
        u, v = labels[i], labels[j]
        loop = u == v
        yield u[~loop], v[~loop]


def pieces(starts: torch.Tensor, piece: int) -> list:
    """Row boundaries that cut entries into pieces of about ``piece``, row
    ``i`` holding ``[starts[i], starts[i + 1])``: the rows whose first entry
    lies in one stretch of ``piece`` entries. The program cuts its pack by
    the same rule; the benchmark keeps its own copy, so that no change to
    the program's internals can change how the graph is made."""
    stretch = starts[:-1] // piece
    cuts = torch.nonzero(stretch[1:] != stretch[:-1]).squeeze(1) + 1
    return sorted({0, starts.numel() - 1, *cuts.tolist()})


def coo(cfg: dict, device):
    """The simple graph's entries, ``(row, col)`` int32 tensors, both
    directions of each edge once, in the order described above."""
    n = size(cfg)
    rows, cols = [], []
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    for u, v in edges(cfg, device):
        rows.append(torch.stack([u, v], 1).reshape(-1).to(torch.int32))
        cols.append(torch.stack([v, u], 1).reshape(-1).to(torch.int32))
        counts += torch.bincount(rows[-1], minlength=n)
    starts = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=starts[1:])
    del counts
    keep = [torch.zeros(len(r), dtype=torch.bool, device=device) for r in rows]
    cuts = pieces(starts, PIECE)
    del starts
    for lo, hi in zip(cuts, cuts[1:]):
        picked = [((r >= lo) & (r < hi)).nonzero().squeeze(1) for r in rows]
        key = torch.cat([(r[p].long() - lo) * n + c[p].long()
                         for r, c, p in zip(rows, cols, picked)])
        key, order = torch.sort(key, stable=True)
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        del key
        kept = torch.zeros_like(first)
        kept[order[first]] = True
        del order, first
        for mask, p, part in zip(keep, picked, kept.split([len(p) for p in picked])):
            mask[p] = part
    total = sum(int(mask.sum()) for mask in keep)
    row = torch.empty(total, dtype=torch.int32, device=device)
    col = torch.empty(total, dtype=torch.int32, device=device)
    at = 0
    for k in range(len(rows)):
        idx = keep[k].nonzero().squeeze(1)
        shuffle = traffic.generator(cfg["graph_seed"], traffic.OPERATOR, -2 - k, device)
        idx = idx[torch.randperm(len(idx), generator=shuffle, device=device)]
        row[at:at + len(idx)] = rows[k][idx]
        col[at:at + len(idx)] = cols[k][idx]
        at += len(idx)
        rows[k] = cols[k] = keep[k] = None
    check_entries(cfg, total)
    return row, col


def check_entries(cfg: dict, count: int) -> None:
    """At the configuration's own scale, the entry count it states."""
    if cfg["scale"] == CHECKED_SCALE and count != cfg["stored_entries"]:
        raise RuntimeError(f"graph500: {count} stored entries at scale {CHECKED_SCALE}, the "
                           f"configuration states {cfg['stored_entries']}")


def operators(cfg: dict, seed: int, count: int, device) -> list:
    from pcsc_eigenvalue_solver_project_tpu_torch import SparseGELL
    row, col = coo(cfg, device)
    values = torch.ones(row.numel(), dtype=getattr(torch, cfg["dtype"]), device=device)
    n = size(cfg)
    return [SparseGELL.from_coo(row, col, values, (n, n), device=device)]


@functools.lru_cache(maxsize=1)
def _coo_once(scale: int, edgefactor: int, abc: tuple, graph_seed: int, stored_entries,
              device: str):
    cfg = {"scale": scale, "edgefactor": edgefactor, "abc": abc, "graph_seed": graph_seed,
           "stored_entries": stored_entries}
    return coo(cfg, torch.device(device))


def raw(cfg: dict, seed: int, index: int, device):
    """The same entries, ``(row, col)``, made again from ``graph_seed`` the
    first time a process asks."""
    return _coo_once(cfg["scale"], cfg["edgefactor"], tuple(cfg["abc"]), cfg["graph_seed"],
                     cfg.get("stored_entries"), str(torch.device(device)))
