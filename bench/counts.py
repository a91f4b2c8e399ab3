"""The yardstick's arithmetic: peaks of the card and the least time of a
kernel call. The operations of a model's forward are its kind's file's
(``bench/models/<kind>.py``, ``forward_flops``).

Peaks are NVIDIA's data-sheet numbers of one H100 SXM at its 700 W limit
(dense, no sparsity). ``bound_s`` is the roofline floor of
``chip_smoke.py``'s ``bound()``: every byte a call needs read once and
every output byte written once at the HBM rate, or its operations at the
float32 rate of the CUDA cores, whichever is larger. Counts follow the
work the inputs need (edges that exist, rows that are real), never a
padded or tiled layout of the program's.
"""
from __future__ import annotations

import numpy as np

#: H100 SXM, per card.
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for ``nbytes`` of traffic and ``flops`` operations."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOP_PER_S)


def spmm_bytes_flops(nonzeros: int, src_rows: int, out_rows: int, f: int,
                     batch: int, code_bytes: int = 4, row_bytes: int = 0):
    """(bytes, operations) of one block-CSR product over a batch: 8 bytes
    a nonzero of the adjacency (its value and source index), the source
    table's ``code_bytes`` an entry plus ``row_bytes`` of row parameters a
    row, the output at 4 bytes an entry; one multiply-add a nonzero a
    feature an example."""
    nbytes = nonzeros * 8 + batch * (src_rows * (f * code_bytes + row_bytes)
                                     + out_rows * f * 4)
    return nbytes, 2.0 * nonzeros * f * batch


def segment_bytes_flops(entries: int, src_rows: int, segments: int, f: int,
                        gathered: bool, weighted: bool):
    """(bytes, operations) of one fixed-order segment sum of ``entries``
    terms into ``segments`` rows of ``f`` floats: the order (4 bytes an
    entry), a source index an entry when the terms are ``gathered`` from a
    table of ``src_rows`` rows (else ``src_rows`` = ``entries``, one row an
    entry), a weight an entry when ``weighted``, the segment offsets, the
    source rows once and the output; one add (two with a weight) an entry
    a feature."""
    nbytes = (entries * (4 + (4 if gathered else 0) + (4 if weighted else 0))
              + (segments + 1) * 4 + src_rows * f * 4 + segments * f * 4)
    return nbytes, (2.0 if weighted else 1.0) * entries * f


def fog_edges(part, senders, receivers):
    """(edges within a fog, edges across fogs, rows that cross) of a graph
    under the vertex -> fog assignment ``part``: what the local and the
    halo products of the mesh need."""
    cross = part[senders] != part[receivers]
    return (int((~cross).sum()), int(cross.sum()),
            int(np.unique(senders[cross]).size))


def spmm_layers_s(edges: int, src_rows: int, out_rows: int, dims,
                  batch: int, code_bytes: int = 4, row_bytes: int = 0):
    """Least seconds of one product a layer (input widths ``dims[:-1]``)
    over a batch."""
    return sum(bound_s(*spmm_bytes_flops(edges, src_rows, out_rows, f, batch,
                                         code_bytes, row_bytes))
               for f in dims[:-1])
