"""IEEE 802.11n / 802.16 LDPC code library.

Counterpart of the reference `code` class
(ldpc_jossy/py/ldpc.py:4-503):

  * protograph tables from models/ldpc_tables.py (standard constants)
  * parity-check expansion `pcmat` (ldpc.py:275-300)
  * flat-graph preparation (vdeg/cdeg/intrlv) for the native CPU oracle's
    ABI — re-derived in closed form instead of the reference's port-flag
    scan loops (ldpc.py:303-396): because blocks are traversed row-major
    and each (block, k) pair touches each node once, the check-side port of
    an edge is the rank of its column among the nonzero columns of its row,
    and the variable-side port is the rank of its row among the nonzero rows
    of its column. Fully vectorized numpy, build time only.
  * systematic encoder exploiting the dual-diagonal parity structure
    (ldpc.py:400-460), vectorized over z-bit super-symbols as static
    roll/XOR stages — jittable and vmappable over a batch of info words.
  * decode: the z-structured JAX BP kernel (ops/bp.py), or the C++ CPU
    oracle (native/) for bit-exact reference checking.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..config import LdpcParams
from ..ops.bp import TannerGraph, bp_decode, BpResult
from .ldpc_tables import get_protograph


class LdpcCode:
    """One (standard, rate, z, ptype) LDPC code with encoder and decoders."""

    def __init__(self, params: LdpcParams):
        self.params = params
        self.proto = get_protograph(params.standard, params.rate, params.z,
                                    params.ptype)
        self.z = params.z
        self.Mp, self.Np = self.proto.shape
        self.Kp = self.Np - self.Mp
        self.N = self.Np * self.z      # codeword length (Nv)
        self.K = self.Kp * self.z      # information length
        self.graph = TannerGraph.build(self.proto, self.z)
        self._prepare_flat_graph()
        self._prepare_encoder()

    # ------------------------------------------------------------------
    # flat-graph representation (oracle ABI + structural tests)
    # ------------------------------------------------------------------
    def _prepare_flat_graph(self):
        proto, z = self.proto, self.z
        nz = proto != -1
        self.cdeg = np.repeat(nz.sum(1), z).astype(np.int64)   # (Nc,)
        self.vdeg = np.repeat(nz.sum(0), z).astype(np.int64)   # (Nv,)
        cumc = np.insert(np.cumsum(self.cdeg), 0, 0)
        cumv = np.insert(np.cumsum(self.vdeg), 0, 0)

        xp, yp = np.nonzero(nz)                    # row-major edge order
        shifts = proto[xp, yp] % z
        # rank of this edge's column among nonzero columns of its row
        col_rank = np.concatenate([np.arange(n) for n in nz.sum(1)])
        # rank of this edge's row among nonzero rows of its column
        row_rank = np.zeros_like(xp)
        for j in range(self.Np):
            ids = np.flatnonzero(yp == j)
            order = np.argsort(xp[ids], kind="stable")
            row_rank[ids[order]] = np.arange(ids.size)

        k = np.arange(z)
        cind = xp[:, None] * z + k[None, :]                      # (E, z)
        vind = yp[:, None] * z + (k[None, :] + shifts[:, None]) % z
        cpos = cumc[cind] + col_rank[:, None]
        vpos = cumv[vind] + row_rank[:, None]
        intrlv = np.empty(int(self.cdeg.sum()), dtype=np.int64)
        intrlv[vpos.ravel()] = cpos.ravel()
        self.intrlv = intrlv                       # var-order pos -> chk pos
        self.Nv, self.Nc, self.Nmsg = self.N, self.Mp * z, intrlv.size

    def pcmat(self) -> np.ndarray:
        """Dense parity-check matrix: each nonzero protograph entry expands
        to a z x z identity cyclically shifted by the entry (ldpc.py:275-300)."""
        proto, z = self.proto, self.z
        H = np.zeros((z * self.Mp, z * self.Np), dtype=int)
        I = np.eye(z, dtype=int)
        for i, j in zip(*np.nonzero(proto != -1)):
            H[i * z:(i + 1) * z, j * z:(j + 1) * z] = \
                np.roll(I, proto[i, j] % z, axis=1)
        return H

    # ------------------------------------------------------------------
    # systematic encoder
    # ------------------------------------------------------------------
    def _prepare_encoder(self):
        """Precompute the dual-diagonal encoder (ldpc.py:400-460) as a
        generator matrix.

        The reference encodes by z-bit super-symbol accumulation + back
        substitution — a long sequential chain of cyclic rolls, a poor shape
        for a vector machine. Encoding is linear over GF(2), so we run that
        chain ONCE at build time on the K unit vectors (vectorized numpy) to
        get the parity generator Gp (K, N-K); on device, encoding is then a
        single matmul `parity = (info @ Gp) mod 2`."""
        proto, z, Kp, Mp = self.proto, self.z, self.Kp, self.Mp
        # systematic accumulation: p[j] = XOR_k roll(x[k], -proto[j,k])
        self._sys_edges = [(j, k, int(proto[j, k]))
                           for j in range(Mp) for k in range(Kp)
                           if proto[j, k] != -1]
        # first parity column Kp: shifts come in pairs except one
        toff = np.zeros(z, dtype=int)
        for j in np.flatnonzero(proto[:, Kp] != -1):
            toff[proto[j, Kp] % z] += 1
        tnz = np.flatnonzero(toff % 2)
        if tnz.size != 1:
            raise ValueError("column Kp offsets do not reduce to one offset")
        self._toff = int(tnz[0])
        # back-substitution: x[Kp+j+1] = p[j] XOR_k roll(x[Kp+k], -shift)
        self._bs_edges = [
            [(Kp + k, int(proto[j, Kp + k]))
             for k in np.flatnonzero(proto[j, Kp:Kp + j + 1] != -1)]
            for j in range(Mp - 1)]
        # parity generator: row i = parity bits of unit info word e_i.
        # 0/1 entries are exact in bfloat16 and each dot product is an
        # integer <= K < 2^24, exact in an f32 accumulator.
        assert self.K < (1 << 24), \
            "matmul encoder exactness requires K < 2^24 (f32 accumulator)"
        gp = self.parity_chain(np.eye(self.K, dtype=np.int64))
        self._Gp = jnp.asarray(gp, jnp.bfloat16)

    def parity_chain(self, info: np.ndarray) -> np.ndarray:
        """Reference dual-diagonal parity chain (ldpc.py:400-460), batched
        numpy. info: (B, K) {0,1} -> (B, N-K). Build-time generator
        construction and the oracle for testing the matmul encoder."""
        z, Kp, Mp = self.z, self.Kp, self.Mp
        xs = info.reshape(-1, Kp, z)
        p = np.zeros((xs.shape[0], Mp, z), np.int64)
        for j, k, shift in self._sys_edges:
            p[:, j] += np.roll(xs[:, k], -shift, axis=-1)
        p %= 2
        tp = p.sum(axis=1) % 2
        parity = [np.roll(tp, self._toff, axis=-1)]
        for j in range(Mp - 1):
            acc = p[:, j].copy()
            for col, shift in self._bs_edges[j]:
                acc = acc + np.roll(parity[col - Kp], -shift, axis=-1)
            parity.append(acc % 2)
        return np.concatenate(parity, axis=-1)

    def encode(self, info: jnp.ndarray) -> jnp.ndarray:
        """Systematic encoding. info: (..., K) {0,1} -> (..., N).

        One generator matmul (see _prepare_encoder); output is bit-identical
        to the reference's super-symbol chain (ldpc.py:400-460) — asserted
        against `parity_chain` in tests/test_ldpc.py."""
        info = jnp.asarray(info)
        assert info.shape[-1] == self.K
        # bf16 0/1 inputs, f32 accumulation: every product and partial sum
        # is an integer below 2^24, so the result is exact at any precision
        acc = jnp.matmul(info.astype(jnp.bfloat16), self._Gp,
                         preferred_element_type=jnp.float32)
        parity = acc.astype(jnp.int32) % 2
        return jnp.concatenate([info.astype(jnp.int32), parity], axis=-1)

    # ------------------------------------------------------------------
    # decoders
    # ------------------------------------------------------------------
    def decode(self, ch: jnp.ndarray, max_itcount: int = 200,
               dectype: str = "sumprod2",
               corr_factor: float = 0.7) -> BpResult:
        """BP decode of channel LLRs (API of ldpc.py:463-490).

        ch: (..., N) LLRs. Returns (app, iterations).
        """
        method = "minsum" if dectype == "minsum" else "sumprod"
        ch = jnp.asarray(ch, jnp.float32)
        return bp_decode(ch, self.graph, max_iters=max_itcount, method=method,
                         corr_factor=corr_factor)

    def Lxor(self, L1: float, L2: float, corrflag: int = 1) -> float:
        """Pairwise LLR-XOR via the native oracle (API of ldpc.py:492-495)."""
        from ..native import oracle
        return oracle.lxor(float(L1), float(L2), corrflag)

    def Lxfb(self, L, corrflag: int = 1):
        """Extrinsic LLRs via the native oracle (API of ldpc.py:497-503).
        Returns (aggregate, extrinsic_array)."""
        from ..native import oracle
        total, ext = oracle.lxfb(np.asarray(L, np.float64), corrflag)
        return total, ext

    def decode_ref(self, ch: np.ndarray, max_itcount: int = 200,
                   dectype: str = "sumprod2",
                   corr_factor: float = 0.7) -> Tuple[np.ndarray, int]:
        """Decode via the native C++ CPU oracle (bit-exact float64 port of
        c_ldpc.c). Used as the validation oracle for the JAX kernel."""
        from ..native import oracle
        return oracle.decode(np.asarray(ch, np.float64), self.vdeg, self.cdeg,
                             self.intrlv, max_itcount, dectype, corr_factor)


@functools.lru_cache(maxsize=64)
def get_code(standard: str, rate: str, z: int, ptype: str = "A") -> LdpcCode:
    """Cached code constructor (graph prep is host-side work worth sharing)."""
    return LdpcCode(LdpcParams(standard=standard, rate=rate, z=z, ptype=ptype))
