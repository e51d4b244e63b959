"""LDPC belief propagation over the z-structured Tanner graph.

Vectorized redesign of the reference's flat-graph C kernel
(`sumprod` / `sumprod2` / `minsum`, ldpc_jossy/src/c_ldpc.c:32-381).

Layout. IEEE 802.11n/802.16 codes are protograph codes: every nonzero
protograph entry (i, j, shift s) is a z x z cyclically-shifted identity
connecting check block i to variable block j. Instead of the reference's
irregular flat arrays addressed through an interleaver (arbitrary gather —
hostile to a vector machine), messages live in a dense (E, z) array, one row
per protograph edge. Check (i, c) connects variable (j, (c + s) mod z), so
the check-aligned <-> variable-aligned conversion is a *fixed permutation
along the z axis*, precomputed at build time. One BP iteration is then:

  variable update:  tot[j] = ch[j] + sum_{e: col(e)=j} c2v_var[e]
                    v2c_var[e] = tot[col(e)] - c2v_var[e]
  check update:     forward-backward Lxor chain along each check row's
                    padded edge list (the reference's Lxfb trellis,
                    c_ldpc.c:294-314) — max degree <= 24 unrolled steps of
                    elementwise Lxor over all (rows, z) lanes at once.

The variable sum is a fixed-order gather-and-add over each column's edge
list (ops/segments.py), not a scatter-add, so a decode is bit-reproducible
on the GPU.

The check-node operation is the numerically-stable pairwise LLR-XOR form
(`Lxor`, c_ldpc.c:234-251): sign * min + two log1p corrections for
sum-product, correction dropped (+ heuristic scale) for min-sum. This is
exactly the reference's `sumprod2`; the tanh-product `sumprod` variant is
mathematically identical and exists here only through the same kernel.

Early stopping (all parity checks satisfied, c_ldpc.c:95-106) is a masked
per-codeword convergence flag inside a `lax.while_loop` that ends once every
codeword has converged; the returned iteration count matches the C kernel's
(0 when the input already satisfies parity).

Everything vmaps over a leading batch of codewords; batched decode is the
intended fast path (the Monte-Carlo and concatenated decoders batch blocks).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .segments import segment_table, table_sum


_BIG = 1e30  # padding LLR: Lxor identity element (certainly-even parity)


# --------------------------------------------------------------------------
# Graph layout (host-side, numpy, build time)
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)  # eq=False: hash by identity (jit static arg)
class TannerGraph:
    """Static z-structured Tanner-graph layout for one protograph code."""

    z: int
    Np: int                 # protograph columns (24)
    Mp: int                 # protograph rows
    E: int                  # number of edges (nonzero protograph entries)
    edge_row: np.ndarray    # (E,) protograph row of each edge
    edge_col: np.ndarray    # (E,) protograph column of each edge
    edge_shift: np.ndarray  # (E,) cyclic shift of each edge
    to_var: np.ndarray      # (E, z) permutation: chk-aligned -> var-aligned
    to_chk: np.ndarray      # (E, z) inverse permutation
    dc_max: int             # max check degree
    chk_edges: np.ndarray   # (Mp, dc_max) edge ids per check row, -1 padded
    var_edges: np.ndarray   # (Np, dv_max) edge ids per column, -1 padded

    @classmethod
    def build(cls, proto: np.ndarray, z: int) -> "TannerGraph":
        Mp, Np = proto.shape
        rr, cc = np.nonzero(proto != -1)
        shifts = proto[rr, cc] % z
        E = rr.size
        vpos = np.arange(z)[None, :]
        # check (i, c) <-> variable (j, (c + s) mod z):
        #   m_var[e, v] = m_chk[e, (v - s) mod z]
        to_var = (vpos - shifts[:, None]) % z
        to_chk = (vpos + shifts[:, None]) % z
        deg = np.bincount(rr, minlength=Mp)
        dc_max = int(deg.max())
        chk_edges = -np.ones((Mp, dc_max), dtype=np.int64)
        for i in range(Mp):
            ids = np.flatnonzero(rr == i)
            chk_edges[i, :ids.size] = ids
        return cls(z=z, Np=Np, Mp=Mp, E=E,
                   edge_row=rr.astype(np.int32), edge_col=cc.astype(np.int32),
                   edge_shift=shifts.astype(np.int32),
                   to_var=to_var.astype(np.int32), to_chk=to_chk.astype(np.int32),
                   dc_max=dc_max, chk_edges=chk_edges,
                   var_edges=segment_table(cc, Np))

    @property
    def Nv(self) -> int:
        return self.Np * self.z

    @property
    def Nc(self) -> int:
        return self.Mp * self.z


# --------------------------------------------------------------------------
# Pairwise LLR-XOR (the reference's Lxor, c_ldpc.c:234-251)
# --------------------------------------------------------------------------

def lxor(L1: jnp.ndarray, L2: jnp.ndarray, correction: bool) -> jnp.ndarray:
    """LLR of the XOR of two binary RVs given their LLRs.

    Min-sum core (product of signs, min of magnitudes) plus the two-term
    correction that makes it exactly the sum-product rule. Elementwise.
    """
    sgn = jnp.sign(L1) * jnp.sign(L2)
    sgn = jnp.where(sgn == 0.0, 1.0, sgn)
    out = sgn * jnp.minimum(jnp.abs(L1), jnp.abs(L2))
    if correction:
        out = out + jnp.log1p(jnp.exp(-jnp.abs(L1 + L2)))
        out = out - jnp.log1p(jnp.exp(-jnp.abs(L1 - L2)))
    return out


def lxfb(L: jnp.ndarray, correction: bool) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extrinsic LLRs along axis 0 via the forward-backward trellis
    (`Lxfb`, c_ldpc.c:294-314), vectorized over trailing axes.

    L: (D, ...) incoming LLRs (pad positions must hold +_BIG).
    Returns (extrinsic (D, ...), aggregate (..., ) = Lxor of all inputs,
    used for the parity stopping rule).
    """
    D = L.shape[0]
    f = [L[0]]
    b = [L[D - 1]]
    for k in range(1, D):
        f.append(lxor(f[-1], L[k], correction))
        b.append(lxor(b[-1], L[D - 1 - k], correction))
    b = b[::-1]
    outs = [b[1]] if D > 1 else [jnp.full_like(L[0], _BIG)]
    for k in range(1, D - 1):
        outs.append(lxor(f[k - 1], b[k + 1], correction))
    if D > 1:
        outs.append(f[D - 2])
    return jnp.stack(outs), b[0]


# --------------------------------------------------------------------------
# BP decode
# --------------------------------------------------------------------------

class BpResult(NamedTuple):
    app: jnp.ndarray         # (..., Nv) a-posteriori LLRs
    iterations: jnp.ndarray  # (...,)   iterations until parity satisfied


def _make_bp_iter(ch_blocks, g: TannerGraph, correction: bool, corr_factor):
    """Build the single-BP-iteration body over (Np, z, B) lane-batched
    state. Shared by the while_loop decoder (`_decode_lanes`) and the
    fixed-length traced decoder (`_decode_lanes_trace`)."""
    z, E, Mp, Np = g.z, g.E, g.Mp, g.Np
    B = ch_blocks.shape[-1]
    dtype = ch_blocks.dtype
    edge_col = g.edge_col
    to_var = jnp.asarray(g.to_var)[:, :, None]              # (E, z, 1)
    to_chk = jnp.asarray(g.to_chk)[:, :, None]
    chk_edges = jnp.asarray(g.chk_edges)                    # (Mp, dc_max)
    chk_mask = jnp.asarray(g.chk_edges >= 0)
    safe_edges = jnp.maximum(chk_edges, 0)

    def one_iter(carry):
        t, c2v_chk, app, it, done = carry
        # done: (B,) frozen-codeword flags

        # ---- variable node rule ("sum", c_ldpc.c:54-68) ----
        c2v_var = jnp.take_along_axis(c2v_chk, to_var, axis=1)  # (E, z, B)
        tot = ch_blocks + table_sum(c2v_var, g.var_edges)     # (Np, z, B)
        v2c_var = tot[edge_col] - c2v_var
        v2c_chk = jnp.take_along_axis(v2c_var, to_chk, axis=1)
        app_new = tot

        # ---- check node rule (Lxfb trellis, c_ldpc.c:183-197) ----
        gathered = v2c_chk[safe_edges]                 # (Mp, dc_max, z, B)
        gathered = jnp.where(chk_mask[..., None, None], gathered, _BIG)
        ext, aggr = lxfb(jnp.moveaxis(gathered, 1, 0), correction)
        ext = jnp.moveaxis(ext, 0, 1)                  # (Mp, dc_max, z, B)
        if not correction:
            ext = ext * corr_factor                    # min-sum heuristic
        # scatter extrinsic back to edge space (each edge appears exactly
        # once across all check rows; padded slots routed out of range)
        c2v_new = jnp.zeros((E, z, B), dtype).at[
            jnp.where(chk_mask, chk_edges, E).reshape(-1)
        ].set(ext.reshape(Mp * g.dc_max, z, B), mode="drop")

        parity_ok = jnp.all(aggr > 0.0, axis=(0, 1))   # (B,)

        # freeze finished codewords; count = first t with parity satisfied
        keep = lambda old, new: jnp.where(done, old, new)
        return (t + 1, keep(c2v_chk, c2v_new), keep(app, app_new),
                jnp.where(done | parity_ok, it, it + 1),
                done | parity_ok)

    return one_iter


def _bp_init(ch_blocks, g: TannerGraph, B: int):
    return (jnp.int32(0), jnp.zeros((g.E, g.z, B), ch_blocks.dtype),
            jnp.zeros((g.Np, g.z, B), ch_blocks.dtype),
            jnp.zeros(B, jnp.int32), jnp.zeros(B, bool))


def _decode_lanes(ch: jnp.ndarray, g: TannerGraph, max_iters: int,
                  correction: bool, corr_factor: float) -> BpResult:
    """Batched BP with the codeword batch on the LAST axis.

    ch: (B, Nv). Internally everything is (..., z, B): all message updates
    are elementwise over contiguous batch rows, and the z-axis permutations
    and edge gathers move whole rows of B codewords. The layout is
    inherited and not yet measured against batch-first on the GPU.
    """
    B = ch.shape[0]
    ch_blocks = jnp.moveaxis(ch.reshape(B, g.Np, g.z), 0, -1)  # (Np, z, B)
    one_iter = _make_bp_iter(ch_blocks, g, correction, corr_factor)
    # while_loop: stop as soon as every codeword satisfies parity (the C
    # kernel's break, c_ldpc.c:104-106)
    _, c2v, app, it, done = jax.lax.while_loop(
        lambda c: jnp.logical_and(c[0] < max_iters, ~jnp.all(c[-1])),
        one_iter, _bp_init(ch_blocks, g, B))
    return BpResult(app=jnp.moveaxis(app, -1, 0).reshape(B, g.Np * g.z),
                    iterations=it)


def _decode_lanes_trace(ch: jnp.ndarray, g: TannerGraph, num_iters: int,
                        correction: bool, corr_factor: float):
    """Fixed-length BP recording the APP LLRs after EVERY iteration.

    Returns (app_traj (num_iters, B, Nv), iterations (B,)). Same per-
    iteration math and same parity-freeze semantics as `_decode_lanes`
    (a frozen codeword keeps repeating its converged APP in the trace);
    the per-BP-iteration probe the reference's instrumented decoders used
    for schedule debugging (ldpc_bp_test, sparc_new.py:1195-1232)."""
    B = ch.shape[0]
    ch_blocks = jnp.moveaxis(ch.reshape(B, g.Np, g.z), 0, -1)  # (Np, z, B)
    one_iter = _make_bp_iter(ch_blocks, g, correction, corr_factor)

    def body(carry, _):
        carry = one_iter(carry)
        return carry, carry[2]                         # app after this iter

    carry, app_traj = jax.lax.scan(body, _bp_init(ch_blocks, g, B),
                                   None, length=num_iters)
    app_traj = jnp.moveaxis(app_traj, -1, 1).reshape(num_iters, B,
                                                     g.Np * g.z)
    return app_traj, carry[3]


# kept as the name used by single-codeword callers
def _decode_single(ch: jnp.ndarray, g: TannerGraph, max_iters: int,
                   correction: bool, corr_factor) -> BpResult:
    res = _decode_lanes(ch[None, :], g, max_iters, correction, corr_factor)
    return BpResult(app=res.app[0], iterations=res.iterations[0])


@partial(jax.jit, static_argnames=("g", "max_iters", "correction"))
def _decode_batch_jit(ch, g, max_iters, correction, corr_factor):
    return _decode_lanes(ch, g, max_iters, correction, corr_factor)


def bp_decode_trace(ch: jnp.ndarray, graph: TannerGraph, num_iters: int,
                    method: str = "sumprod", corr_factor: float = 0.7):
    """Decode channel LLRs, recording the APP after every BP iteration.

    ch: (..., Nv). Returns (app_traj (num_iters, ..., Nv), iterations (...))
    — app_traj[j] is the a-posteriori state after iteration j+1, with
    parity-converged codewords frozen (identical semantics to `bp_decode`;
    app_traj[-1] equals bp_decode(...).app whenever num_iters >= the
    convergence iteration)."""
    assert method in ("sumprod", "sumprod2", "minsum")
    correction = method != "minsum"
    cf = jnp.asarray(corr_factor, ch.dtype)
    batch_shape = ch.shape[:-1]
    flat = ch.reshape(-1, ch.shape[-1])
    traj, it = _decode_lanes_trace(flat, graph, num_iters, correction, cf)
    return (traj.reshape((num_iters,) + batch_shape + (ch.shape[-1],)),
            it.reshape(batch_shape))


def bp_decode(ch: jnp.ndarray, graph: TannerGraph, max_iters: int = 200,
              method: str = "sumprod", corr_factor: float = 0.7) -> BpResult:
    """Decode channel LLRs.

    ch       : (..., Nv) channel log-likelihood ratios (LLR > 0 => bit 0)
    method   : 'sumprod' (exact, the reference's sumprod/sumprod2) or
               'minsum' (approximate with correction factor, c_ldpc.c:339-381)
    Returns a-posteriori LLRs and per-codeword iteration counts.
    """
    assert method in ("sumprod", "sumprod2", "minsum")
    correction = method != "minsum"
    cf = jnp.asarray(corr_factor, ch.dtype)
    batch_shape = ch.shape[:-1]
    flat = ch.reshape(-1, ch.shape[-1])
    res = _decode_batch_jit(flat, graph, max_iters, correction, cf)
    if ch.ndim == 1:
        return BpResult(app=res.app[0], iterations=res.iterations[0])
    return BpResult(app=res.app.reshape(batch_shape + (ch.shape[-1],)),
                    iterations=res.iterations.reshape(batch_shape))
