"""Seeded Hadamard SPARC design operator (SRHT form).

This is the single design-matrix engine behind every codec in the framework,
replacing BOTH of the reference's engines:

  * the seeded subsampled DCT/FFT closures of sparc_public
    (`sub_dct` / `sub_fft` / `sparc_transforms`, sparc_public/sparc.py:593-880)
  * the dense n x LM Gaussian matrix of sparc_sophie
    (`create_design_matrix`, sparc_sophie/sparc_new.py:1284-1294)

Ensemble. Each nonzero base-matrix block (r, c) of the (Lr x Lc) blocked
design is a sqrt(W[r,c]/L)-scaled subsampled randomized Hadamard transform
(SRHT): one side of the Mr x Mc block indexes a *random subset* of H_w
rows/columns, the other side a *contiguous window* [1, dim+1) with a random
+-1 sign diagonal. This is the same subsampled-Hadamard family the reference
documents (sparc_public/sparc.py:703-728), with one side's randomness
carried by the sign diagonal instead of a second random subset.

Two structural rules make this both sound and fast:

  * The random index set goes on the SMALLER of (Mr, Mc) and the contiguous
    window on the LARGER. Soundness: a Hadamard row's pattern over columns
    [1, C+1) is determined by its index mod 2^ceil(log2(C+1)); with
    C = max(Mr, Mc) and w = next_pow2(C+1) that modulus is w itself, so all
    index candidates in [1, w) produce distinct, pseudo-random patterns.
    (With the window on the smaller side, patterns repeat every 2^k << w and
    tall blocks would get duplicated rows — catastrophic for AMP.)
  * Speed: the device scatter/gather only ever touches min(Mr, Mc) elements
    (sorted + unique), while the large side is a free zero-pad / contiguous
    slice that XLA fuses into the FWHT matmuls. The reference-style random
    subset on BOTH sides needs a 2^19-element random scatter per product,
    which dominated the AMP iteration where it was first measured.

Column/row 0 (all-ones) is excluded everywhere. The Hadamard / DCT /
Gaussian ensembles are statistically interchangeable for AMP at these block
lengths; parity is asserted on BER curves and SE agreement (SURVEY.md
section 7).

Device mapping: the FWHT is a Kronecker chain of small dense matmuls
(ops/wht.py); per-block products batch over the nonzero-block list, so the
spatially-coupled band structure costs exactly its nonzero blocks. Row- and
column-block sums are fixed-order gathers (ops/segments.py), never
scatter-adds, so products are bit-reproducible on the GPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .wht import fwht
from .segments import segment_table, table_sum
from ..config import SparcParams, create_base_matrix


def _next_pow2_at_least(x: int) -> int:
    return 1 << (x - 1).bit_length()


def generate_block_randomness(W: np.ndarray, Mr: int, Mc: int, w: int,
                              seed, offset: int = 1
                              ) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """Per-nonzero-block randomness for the SRHT blocks.

    Blocks are visited row-major (the traversal order of `generate_ordering`,
    sparc_public/sparc.py:735-775) with one seeded stream, so blocks get
    independent draws. Index sets are sorted ascending (the ensemble
    randomness is in *which* indices are selected — Hadamard rows are
    exchangeable — and sorted indices make the device gather/scatter a
    monotone stream).

    Returns (rows, cols, idx, signs):
      rows, cols : (E,) block coordinates of the E nonzero blocks
      idx        : (E, min(Mr, Mc)) sorted H_w indices for the small side
      signs      : (E, max(Mr, Mc)) +-1 diagonal for the large (window) side
    """
    rng = np.random.default_rng(seed)
    Lr, Lc = W.shape
    small, large = min(Mr, Mc), max(Mr, Mc)
    if offset == 0:
        # full window [0, w): every distinct pair of Hadamard rows is exactly
        # orthogonal over the whole row, so ALL indices (including 0, whose
        # window pattern is the random sign diagonal itself) are candidates.
        Q = w
        base = np.arange(0, Q, dtype=np.int32)
    else:
        # Index candidates are restricted to [1, Q): two indices must differ
        # in a bit that is DENSELY covered by the window [1, large+1),
        # otherwise their Hadamard patterns over the window are
        # near-identical (e.g. indices differing only in bit log2(large)
        # share all but one window column — observed to break AMP). Bits
        # 0..floor(log2(large))-1 each cover ~half the window, so
        # Q = 2^floor(log2(large)) is safe; escalate only if the block needs
        # more than Q-1 indices (square-ish blocks), which trades in a small
        # fraction of weakly-covered index pairs.
        Q = 1 << int(np.floor(np.log2(large)))
        while Q <= small:
            Q *= 2
        Q = min(Q, w)
        base = np.arange(1, Q, dtype=np.int32)
    rows, cols, idxs, sgns = [], [], [], []
    for r in range(Lr):
        for c in range(Lc):
            if W[r, c] != 0:
                rows.append(r)
                cols.append(c)
                idxs.append(np.sort(rng.choice(base, small, replace=False)))
                sgns.append(rng.integers(0, 2, large).astype(np.float32) * 2 - 1)
    return (np.array(rows, dtype=np.int32), np.array(cols, dtype=np.int32),
            np.stack(idxs), np.stack(sgns))


def srht_apply(vals: jnp.ndarray, idx: jnp.ndarray, signs: jnp.ndarray,
               w: int, in_dim: int, out_dim: int,
               idx_side_is_input: bool, offset: int = 1,
               scale: jnp.ndarray | None = None) -> jnp.ndarray:
    """Batched per-block SRHT product, (E, in_dim) -> (E, out_dim).

    idx_side_is_input: whether the random index set addresses the input
    dimension (scatter in) or the output dimension (gather out). The other
    side is the signed contiguous window [offset, dim+offset) — offset 0 is
    the full-width true-SRHT window used when the window side is itself a
    power of two (halving w vs the offset-1 skip-row-0 layout).

    scale: optional (E,) per-block multipliers (XLA fuses the broadcast
    multiply into the transform's neighbours).

    The scatter and gather promise XLA sorted, unique indices: idx rows
    come from `generate_block_randomness` (np.sort of a draw without
    replacement).
    """
    E = vals.shape[0]
    if idx_side_is_input:
        # scale commutes through the linear transform: apply it on the
        # small scattered side, O(small) instead of O(w)
        if scale is not None:
            vals = vals * scale[:, None].astype(vals.dtype)
        X = jnp.zeros((E, w), dtype=vals.dtype)
        X = X.at[jnp.arange(E)[:, None], idx].set(
            vals, indices_are_sorted=True, unique_indices=True)
        Y = fwht(X)
        if offset == 0 and out_dim == w:
            win = Y
        else:
            win = Y[:, offset:out_dim + offset]
        return win * signs.astype(vals.dtype)
    else:
        signed = vals * signs.astype(vals.dtype)
        if offset == 0 and in_dim == w:
            X = signed
        else:
            X = jnp.pad(signed, ((0, 0), (offset, w - offset - in_dim)))
        Y = fwht(X)
        out = Y.at[jnp.arange(E)[:, None], idx].get(
            indices_are_sorted=True, unique_indices=True)
        if scale is not None:
            out = out * scale[:, None].astype(out.dtype)
        return out


@jax.tree_util.register_pytree_node_class
@dataclass
class SparcDesign:
    """Blockwise SRHT design operator.

    Array leaves (jit/vmap-traceable):
      idx   : (E, min(Mr, Mc)) int32  per-block H_w indices, sorted
      signs : (E, max(Mr, Mc)) float32 per-block +-1 window signs
      scale : (E,) float32 per-block sqrt(W[r,c]/L)
    Static metadata:
      rows/cols : nonzero-block coordinates; shapes Lr, Lc, Mr, Mc, w, n, LM.
      tall      : Mr > Mc (index set on columns) or not (index set on rows).
    """

    idx: jnp.ndarray
    signs: jnp.ndarray
    scale: jnp.ndarray
    rows: tuple
    cols: tuple
    Lr: int
    Lc: int
    Mr: int
    Mc: int
    w: int
    n: int
    LM: int
    offset: int = 1

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return ((self.idx, self.signs, self.scale),
                (self.rows, self.cols, self.Lr, self.Lc, self.Mr, self.Mc,
                 self.w, self.n, self.LM, self.offset))

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    @property
    def tall(self) -> bool:
        return self.Mr > self.Mc

    def with_leaves(self, idx, signs, scale=None) -> "SparcDesign":
        """Rebuild with replaced array leaves, carrying ALL static metadata.

        Callers that stack/select design randomness (Monte-Carlo fan-out)
        must use this instead of positional construction, so that future
        field additions cannot silently desync (round-1 regression: a new
        `offset` field defaulted to 1 while `w` was built for offset 0,
        producing negative pad widths for power-of-two blocks)."""
        leaves, aux = self.tree_flatten()
        new_leaves = (idx, signs, leaves[2] if scale is None else scale)
        return type(self).tree_unflatten(aux, new_leaves)

    # -- construction -------------------------------------------------------
    @classmethod
    def build(cls, W: np.ndarray, L: int, M: int, n: int, seed) -> "SparcDesign":
        """Build the operator for base matrix W (2-D (Lr, Lc)).

        Shapes follow sparc_public/sparc.py:777-837: Mr = n/Lr rows and
        Mc = L*M/Lc columns per block; transform size w = next power of two
        with room to skip the all-ones row/column 0.
        """
        W = np.atleast_2d(np.asarray(W, dtype=np.float64))
        Lr, Lc = W.shape
        assert n % Lr == 0, "Lr must divide n"
        assert (L * M) % Lc == 0, "Lc must divide L*M"
        Mr, Mc = n // Lr, (L * M) // Lc
        large = max(Mr, Mc)
        if large & (large - 1) == 0:
            # window side is a power of two: full-width true-SRHT window,
            # no skip of row 0 (the sign diagonal randomizes it) — halves
            # the transform width vs next_pow2(large + 1)
            w, offset = large, 0
        else:
            w, offset = _next_pow2_at_least(large + 1), 1
        rows, cols, idx, sgns = generate_block_randomness(W, Mr, Mc, w, seed,
                                                          offset)
        scale = np.sqrt(W[rows, cols] / L).astype(np.float32)
        return cls(jnp.asarray(idx), jnp.asarray(sgns), jnp.asarray(scale),
                   tuple(int(r) for r in rows), tuple(int(c) for c in cols),
                   Lr, Lc, Mr, Mc, w, n, L * M, offset)

    @classmethod
    def for_params(cls, params: SparcParams, awgn_var: float, seed) -> "SparcDesign":
        W = create_base_matrix(params, awgn_var)
        return cls.build(W, params.L, params.M, params.codeword_length(), seed)

    # -- products -----------------------------------------------------------
    @property
    def E(self) -> int:
        return len(self.rows)

    def _fwd_blocks(self, vals: jnp.ndarray) -> jnp.ndarray:
        """(E, Mc) column-block values -> (E, Mr) row-block contributions."""
        return srht_apply(vals, self.idx, self.signs, self.w, self.Mc,
                          self.Mr, idx_side_is_input=self.tall,
                          offset=self.offset, scale=self.scale)

    def _adj_blocks(self, vals: jnp.ndarray) -> jnp.ndarray:
        """(E, Mr) row-block values -> (E, Mc) column-block contributions
        (H symmetric: the adjoint swaps which side is scatter/gather)."""
        return srht_apply(vals, self.idx, self.signs, self.w, self.Mr,
                          self.Mc, idx_side_is_input=not self.tall,
                          offset=self.offset, scale=self.scale)

    def ab(self, beta: jnp.ndarray) -> jnp.ndarray:
        """A @ beta. beta: (..., L*M) -> (..., n).

        Blockwise: out_row_block[r] = sum_c A_rc @ beta_col_block[c]
        (forward product of sparc_public/sparc.py:851-862).
        """
        if beta.ndim > 1:
            return jax.vmap(self.ab)(beta)
        xb = beta.reshape(self.Lc, self.Mc)
        parts = self._fwd_blocks(xb[np.asarray(self.cols)])       # (E, Mr)
        out = table_sum(parts, segment_table(self.rows, self.Lr))
        return out.reshape(self.n)

    def az(self, z: jnp.ndarray) -> jnp.ndarray:
        """A.T @ z. z: (..., n) -> (..., L*M)
        (adjoint product of sparc_public/sparc.py:864-875)."""
        if z.ndim > 1:
            return jax.vmap(self.az)(z)
        zb = z.reshape(self.Lr, self.Mr)
        parts = self._adj_blocks(zb[np.asarray(self.rows)])       # (E, Mc)
        out = table_sum(parts, segment_table(self.cols, self.Lc))
        return out.reshape(self.LM)

    # -- test utilities -----------------------------------------------------
    def dense(self) -> np.ndarray:
        """Materialize A as a dense (n, L*M) numpy array. Tests only."""
        eye = jnp.eye(self.LM, dtype=jnp.float32)
        return np.asarray(jax.vmap(self.ab)(eye)).T


@jax.tree_util.register_pytree_node_class
@dataclass
class DftDesign:
    """Seeded subsampled-DFT design operator — EXACTLY the reference's
    complex ensemble (sub_fft, sparc_public/sparc.py:593-646):
    A = sqrt(P/L) * F_w[rows][:, cols], with F the unnormalized w-point
    DFT matrix (unit-modulus entries) and rows/cols drawn without
    replacement from [0, w) \\ {0, w/2}.

    Opt-in alternative to the default real-SRHT design for complex
    SPARCs: the SRHT is the default (matmul transforms; SRHT against
    cuFFT is not yet measured on the GPU), but the two structured
    ensembles sit ~0.25 linear snr units apart on the K=4 waterfall cliff
    at L=2048 (docs/artifacts/oracle_parity_mod.json) — users needing the
    reference's exact ensemble select this engine. Scalar base matrix
    only (the reference's complex families are all plain-W).

    Array leaves: rows (n,), cols (LM,) int32 subsample index sets.
    Static: w, n, LM, scale.
    """

    rows: jnp.ndarray
    cols: jnp.ndarray
    w: int
    n: int
    LM: int
    scale: float

    def tree_flatten(self):
        return ((self.rows, self.cols), (self.w, self.n, self.LM, self.scale))

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    def with_leaves(self, rows, cols) -> "DftDesign":
        """Rebuild with replaced array leaves, carrying the static
        metadata (same contract as SparcDesign.with_leaves)."""
        _, aux = self.tree_flatten()
        return type(self).tree_unflatten(aux, (rows, cols))

    @classmethod
    def for_params(cls, params, awgn_var: float, seed) -> "DftDesign":
        assert params.is_complex, "DftDesign is the complex-code engine"
        assert params.base_matrix_ndim() == 0, \
            "DftDesign supports the plain (scalar-W) families only"
        n, LM = params.codeword_length(), params.L * params.M
        w = 1 << int(np.ceil(np.log2(max(n + 2, LM + 2))))
        rng = np.random.default_rng(seed)
        allowed = np.delete(np.arange(w, dtype=np.int32), [0, w // 2])
        rows = np.sort(rng.permutation(allowed)[:n])
        cols = np.sort(rng.permutation(allowed)[:LM])
        return cls(jnp.asarray(rows), jnp.asarray(cols), w, n, LM,
                   float(np.sqrt(params.P / params.L)))

    def ab(self, beta: jnp.ndarray) -> jnp.ndarray:
        """A @ beta. beta: (..., LM) complex -> (..., n) complex."""
        if beta.ndim > 1:
            return jax.vmap(self.ab)(beta)
        x_ext = jnp.zeros(self.w, jnp.complex64).at[self.cols].set(
            beta.astype(jnp.complex64))
        return (self.scale * jnp.fft.fft(x_ext)[self.rows])

    def az(self, z: jnp.ndarray) -> jnp.ndarray:
        """A^H @ z (adjoint: conj(F)^T = conj . fft . conj)."""
        if z.ndim > 1:
            return jax.vmap(self.az)(z)
        y_ext = jnp.zeros(self.w, jnp.complex64).at[self.rows].set(
            z.astype(jnp.complex64))
        return (self.scale *
                jnp.conj(jnp.fft.fft(jnp.conj(y_ext)))[self.cols])

    # -- test utilities -----------------------------------------------------
    def dense(self) -> np.ndarray:
        """Materialize A as a dense (n, LM) numpy array. Tests only."""
        eye = jnp.eye(self.LM, dtype=jnp.complex64)
        return np.asarray(jax.vmap(self.ab)(eye)).T


def stack_designs(params, awgn_var: float, seed, count: int,
                  engine: str = "srht"):
    """A stack of `count` independent designs (fresh A per Monte-Carlo
    trial, as the reference draws a new seeded transform per run,
    performance_plots_general.py:102). Design d is seeded (seed, d) — the
    ONE seed convention for every Monte-Carlo entry point (the module
    docstring of parallel/montecarlo.py).

    Engine-generic: returns (proto, stacked_leaves) where proto is the
    first design (static metadata carrier) and stacked_leaves is a tuple
    of its pytree leaves with a leading `count` axis (idx/signs/scale
    for the SRHT engine, rows/cols for the DFT engine). Rebuild design d
    with `type(proto).tree_unflatten(aux, [l[d] for l in leaves])` —
    exactly what parallel/montecarlo.sparc_mc_counts does."""
    from ..models.sparc import design_for_params  # lazy: avoids a cycle
    designs = [design_for_params(params, awgn_var, (seed, d), engine)
               for d in range(count)]
    leaves = tuple(jnp.stack(ls) for ls in
                   zip(*[d.tree_flatten()[0] for d in designs]))
    return designs[0], leaves
