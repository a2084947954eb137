"""NR LDPC base-graph access (TS 38.212 §5.3.2, Tables 5.3.2-1/-2/-3).

Port of ``srsran_edgeric_5g_tpu/ops/ldpc/graph.py``.  The shift-coefficient
tables are packed spec constants in this package's ``data/ldpc_graphs.npz``;
this module exposes them as per-(BG, Zc) edge lists, the form every
downstream op and the CUDA decoder consume.
"""

from __future__ import annotations

import dataclasses
import functools
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parents[2] / "data" / "ldpc_graphs.npz"

BG1, BG2 = 1, 2

# Message (systematic) columns per base graph: K = KB_MAX * Zc.
KB_MAX = {BG1: 22, BG2: 10}
NUM_ROWS = {BG1: 46, BG2: 42}
NUM_COLS = {BG1: 68, BG2: 52}


@functools.lru_cache(maxsize=None)
def _tables():
    d = np.load(_DATA)
    return ({BG1: d["bg1_shifts"], BG2: d["bg2_shifts"]},
            d["lifting_sizes"].tolist(), d["lifting_index"])


def lifting_sizes() -> tuple[int, ...]:
    return tuple(_tables()[1])


def lifting_index(zc: int) -> int:
    idx = int(_tables()[2][zc])
    if idx < 0:
        raise ValueError(f"invalid lifting size {zc}")
    return idx


def min_lifting_size(kb: int, k_prime: int) -> int:
    """Smallest valid Zc with kb*Zc >= k_prime (TS 38.212 §5.2.2)."""
    for z in lifting_sizes():
        if kb * z >= k_prime:
            return z
    raise ValueError(f"no lifting size for kb={kb}, K'={k_prime}")


@dataclasses.dataclass(frozen=True)
class LdpcGraph:
    """One lifted base graph: edge list with shifts already reduced mod Zc.
    Edges are in row-major order (by row, then column)."""

    bg: int
    zc: int
    rows: int               # check-node blocks
    cols: int               # variable-node blocks (message + parity)
    kb: int                 # message blocks
    edge_row: np.ndarray    # (E,) int32
    edge_col: np.ndarray    # (E,) int32
    edge_shift: np.ndarray  # (E,) int32, in [0, Zc)
    shifts: np.ndarray      # (rows, cols) int32, -1 = no edge

    @property
    def num_edges(self) -> int:
        return len(self.edge_row)

    @property
    def k(self) -> int:
        return self.kb * self.zc

    @property
    def n_full(self) -> int:
        """Full codeword bits incl. the 2*Zc punctured systematic bits."""
        return self.cols * self.zc

    @property
    def n(self) -> int:
        """Rate-matching circular buffer length N = (cols-2)*Zc (§5.3.2)."""
        return (self.cols - 2) * self.zc

    def max_row_degree(self) -> int:
        return int(np.bincount(self.edge_row, minlength=self.rows).max())


@functools.lru_cache(maxsize=None)
def get_graph(bg: int, zc: int) -> LdpcGraph:
    v = _tables()[0][bg][lifting_index(zc)].astype(np.int32)  # -1 = no edge
    shifts = np.where(v >= 0, v % zc, -1).astype(np.int32)
    r, c = np.nonzero(shifts >= 0)
    return LdpcGraph(bg=bg, zc=zc, rows=NUM_ROWS[bg], cols=NUM_COLS[bg],
                     kb=KB_MAX[bg], edge_row=r.astype(np.int32),
                     edge_col=c.astype(np.int32), edge_shift=shifts[r, c],
                     shifts=shifts)


def build_parity_check_dense(g: LdpcGraph) -> np.ndarray:
    """Expanded H as (rows*Zc, cols*Zc) uint8.

    Edge (r, c, s) makes check z of block r involve variable (z + s) mod Zc
    of block c (TS 38.212's P^{s} cyclic-permutation submatrix).
    """
    zc = g.zc
    h = np.zeros((g.rows * zc, g.cols * zc), dtype=np.uint8)
    z = np.arange(zc)
    for r, c, s in zip(g.edge_row, g.edge_col, g.edge_shift):
        h[r * zc + z, c * zc + (z + s) % zc] ^= 1
    return h


def gf2_inv(a: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix by Gauss-Jordan elimination (host-side)."""
    n = a.shape[0]
    m = np.concatenate([a.astype(np.uint8) % 2, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(m[col:, col]))
        if m[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(2) matrix")
        if piv != col:
            m[[col, piv]] = m[[piv, col]]
        rows = np.nonzero(m[:, col])[0]
        rows = rows[rows != col]
        m[rows] ^= m[col]
    return m[:, n:]
