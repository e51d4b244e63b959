"""Typed configuration for SPARC / LDPC / concatenated codes.

Re-design of the reference's dict-based parameter plumbing
(`check_code_params` / `check_decode_params`, sparc_public/sparc.py:77-170,
and `param_calc` / `param_calc_semi_protected`, ldpc_sparc/param_calc.py:11-58).

Instead of validate-and-rewrite-in-place dicts, we use frozen dataclasses with
derived quantities computed once at construction. All fields are static Python
values (hashable) so configs can be closed over by `jax.jit` without
retracing hazards.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


def is_power_of_2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


# --------------------------------------------------------------------------
# SPARC code parameters
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SparcParams:
    """Parameters of a Sparse Regression Code.

    Mirrors the semantic content of `check_code_params`
    (sparc_public/sparc.py:77-149): P, R, L, M plus the four type flags and
    their type-specific extras.

    P : average codeword symbol power constraint
    R : design rate (user bits / channel uses)
    L : number of sections
    M : entries per section (power of two)
    K : PSK modulation order (1 = unmodulated)
    """

    P: float
    R: float
    L: int
    M: int
    is_complex: bool = False
    modulated: bool = False
    K: int = 1
    power_allocated: bool = False
    B: int = 0
    R_PA_ratio: float = 0.0
    spatially_coupled: bool = False
    omega: int = 0
    Lambda: int = 0

    def __post_init__(self):
        assert self.P > 0, "P must be positive"
        assert self.R > 0, "R must be positive"
        assert isinstance(self.L, int) and self.L > 0
        assert isinstance(self.M, int) and self.M > 0 and is_power_of_2(self.M), \
            "M must be a positive power of 2"
        if self.modulated:
            assert self.K > 1 and is_power_of_2(self.K), "K must be a power of 2 > 1"
            if not self.is_complex:
                assert self.K == 2, "real modulated SPARCs require K=2"
        else:
            object.__setattr__(self, "K", 1)
        if self.power_allocated:
            assert self.B > 1, "B must be > 1"
            assert self.L % self.B == 0, "B must divide L"
            assert self.R_PA_ratio >= 0
        if self.spatially_coupled:
            assert self.omega > 1, "omega must be > 1"
            assert self.Lambda >= 2 * self.omega - 1, "Lambda must be >= 2*omega-1"
            assert self.L % self.Lambda == 0, "Lambda must divide L"
        if self.power_allocated and self.spatially_coupled:
            assert self.L % (self.Lambda * self.B) == 0, "Lambda*B must divide L"

    # ---- derived quantities -------------------------------------------------

    @property
    def logM(self) -> int:
        return self.M.bit_length() - 1

    @property
    def logK(self) -> int:
        return self.K.bit_length() - 1

    @property
    def sec_size(self) -> int:
        """Bits per section (location bits + value bits)."""
        return self.logM + self.logK

    @property
    def bit_len(self) -> int:
        """Total number of message bits, L*log2(K*M)."""
        return self.L * self.sec_size

    @property
    def n_design(self) -> int:
        """Design codeword length round(bit_len / R), before row-block rounding.

        Matches sparc_public/sparc.py:39.
        """
        return int(round(self.bit_len / self.R))

    def codeword_length(self) -> int:
        """Actual codeword length n (rounded to a multiple of the number of
        row blocks Lr for spatially-coupled codes, sparc_public/sparc.py:40-43)."""
        n = self.n_design
        Lr, _ = self.base_matrix_shape()
        if Lr > 1:
            Mr = int(round(n / Lr))
            n = Mr * Lr
        return n

    @property
    def n(self) -> int:
        return self.codeword_length()

    @property
    def R_actual(self) -> float:
        return self.bit_len / self.codeword_length()

    def base_matrix_shape(self) -> Tuple[int, int]:
        """(Lr, Lc) of the base matrix W in its unified 2-D form.

        plain       -> (1, 1)
        PA          -> (1, B)
        SC          -> (Lambda+omega-1, Lambda)
        PA + SC     -> (Lambda+omega-1, Lambda*B)
        """
        if self.spatially_coupled:
            Lr = self.Lambda + self.omega - 1
            Lc = self.Lambda * (self.B if self.power_allocated else 1)
        else:
            Lr = 1
            Lc = self.B if self.power_allocated else 1
        return Lr, Lc

    def base_matrix_ndim(self) -> int:
        """The reference's W.ndim (0 scalar / 1 PA vector / 2 SC matrix),
        kept for API parity with sparc_public/sparc.py:570-589."""
        if self.spatially_coupled:
            return 2
        if self.power_allocated:
            return 1
        return 0


@dataclass(frozen=True)
class DecodeParams:
    """AMP decoder parameters (`check_decode_params`, sparc_public/sparc.py:151-170)."""

    t_max: int = 25
    rtol: float = 1e-6
    phi_est_method: int = 1

    def __post_init__(self):
        assert isinstance(self.t_max, int) and self.t_max > 1
        assert 0 < self.rtol < 1
        assert self.phi_est_method in (1, 2)


# --------------------------------------------------------------------------
# Base-matrix design (power allocation & spatial coupling)
# --------------------------------------------------------------------------

def pa_iterative(P: float, sigma_sqr: float, B: int, R_PA: float) -> np.ndarray:
    """Iterative power allocation from asymptotic state evolution.

    Same recurrence as `pa_iterative` (sparc_public/sparc.py:516-533): allocate
    exponentially-decaying power to early blocks until flat spreading wins.
    Host-side numpy (build time only).
    """
    Q = np.zeros(B)
    for b in range(B):
        phi = sigma_sqr + P - Q.mean()
        P_block = 2.0 * np.log(2.0) * R_PA * phi
        P_spread = (B * P - Q.sum()) / (B - b)
        if P_block > P_spread:
            Q[b] = P_block
        else:
            Q[b:] = P_spread
            break
    Q /= Q.mean() / P  # normalize so mean power equals P
    return Q


def sc_base_matrix(Q: np.ndarray, omega: int, Lambda: int) -> np.ndarray:
    """(omega, Lambda) band-diagonal spatially-coupled base matrix.

    Semantics of `sc_basic` (sparc_public/sparc.py:535-568): each of the
    Lambda column groups spreads its power over omega consecutive row blocks,
    scaled by Lr/omega so the matrix mean stays P.
    """
    Lr = Lambda + omega - 1
    if Q.ndim == 0:
        W = np.zeros((Lr, Lambda))
        for c in range(Lambda):
            W[c:c + omega, c] = float(Q) * Lr / omega
    elif Q.ndim == 1:
        B = Q.size
        W = np.zeros((Lr, Lambda * B))
        for c in range(Lambda):
            for r in range(c, c + omega):
                W[r, c * B:(c + 1) * B] = Q * Lr / omega
    else:
        raise ValueError("Q must be a scalar or 1-D power allocation")
    assert np.isclose(W.mean(), np.mean(Q)), "base matrix mean must equal P"
    return W


def create_base_matrix(params: SparcParams, awgn_var: float) -> np.ndarray:
    """Construct the base matrix W for `params`, always as a 2-D (Lr, Lc) array.

    Unifies the scalar / vector / matrix return of `create_base_matrix`
    (sparc_public/sparc.py:570-589): a plain SPARC is the (1,1) matrix [[P]],
    a power-allocated one is (1,B), a spatially-coupled one is (Lr,Lc).
    The unified 2-D form lets the AMP decoder use a single code path.
    """
    if params.power_allocated:
        Q = pa_iterative(params.P, awgn_var, params.B, params.R * params.R_PA_ratio)
    else:
        Q = np.array(params.P)

    if params.spatially_coupled:
        W = sc_base_matrix(Q, params.omega, params.Lambda)
    else:
        W = np.atleast_1d(Q)[None, :] if Q.ndim <= 1 else Q
        if W.ndim == 1:
            W = W[None, :]
    return np.asarray(W, dtype=np.float64)


# --------------------------------------------------------------------------
# LDPC code parameters
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LdpcParams:
    """IEEE 802.11n / 802.16 LDPC code selector.

    standard : '802.11n' or '802.16'
    rate     : '1/2', '2/3', '3/4' or '5/6'
    z        : protograph expansion factor ({27,54,81} for 802.11n, >=3 for 802.16)
    ptype    : 'A' or 'B' (802.16 rates 2/3 and 3/4 only)
    """

    standard: str = "802.11n"
    rate: str = "1/2"
    z: int = 27
    ptype: str = "A"

    def __post_init__(self):
        assert self.standard in ("802.11n", "802.16")
        assert self.rate in ("1/2", "2/3", "3/4", "5/6")
        if self.standard == "802.11n":
            assert self.z in (27, 54, 81), "802.11n requires z in {27,54,81}"
        else:
            assert self.z >= 3
        assert self.ptype in ("A", "B")

    @property
    def rate_float(self) -> float:
        num, den = self.rate.split("/")
        return int(num) / int(den)


@dataclass(frozen=True)
class ConcatLengths:
    """Length bookkeeping for the concatenated LDPC-SPARC code
    (the `lengths` dict of ldpc_sparc/param_calc.py:24-27,54-57)."""

    k_ldpc: int
    mults: int
    L_unprotected: int = 0


def param_calc(mults: int, logM: int, ldpc: LdpcParams, int_rate: float,
               R_sparc_ldpc: float, ldpc_K: int) -> Tuple[float, int, int, ConcatLengths]:
    """Fully-protected concatenation bookkeeping (ldpc_sparc/param_calc.py:11-28).

    ldpc_K: information length K of the chosen LDPC code (z * Kp).

    Returns (overall_rate, L_sparc, L_sparc_ldpc, lengths).
    """
    k = ldpc_K * mults
    ldpc_bits_len = k / int_rate
    assert ldpc_bits_len == int(ldpc_bits_len), "ldpc_bits_len must be an integer"
    ldpc_bits_len = int(ldpc_bits_len)
    assert k % logM == 0
    assert ldpc_bits_len % logM == 0
    n = int(ldpc_bits_len / R_sparc_ldpc)
    overall_rate = k / n
    L_sparc = k // logM
    L_sparc_ldpc = ldpc_bits_len // logM
    lengths = ConcatLengths(k_ldpc=k, mults=mults, L_unprotected=0)
    return overall_rate, L_sparc, L_sparc_ldpc, lengths


def param_calc_semi_protected(R: float, mults: int, percent_protected: float,
                              M: int, ldpc: LdpcParams, int_rate: float,
                              ldpc_K: int):
    """Semi-protected concatenation bookkeeping
    (ldpc_sparc/param_calc.py:31-58): an unprotected prefix of sections plus
    LDPC-protected sections.

    Returns (L_sparc, R_sparc_ldpc, L_sparc_ldpc, lengths, updated_rate).
    """
    logM = int(math.log2(M))
    k_ldpc = ldpc_K * mults
    n_ldpc = int(k_ldpc / int_rate)
    assert n_ldpc % logM == 0
    unprotected_bits = int((k_ldpc * (1 - percent_protected)) / percent_protected)
    unprotected_bits = int(math.ceil(unprotected_bits / logM) * logM)

    L_sparc_ldpc_logM = n_ldpc + unprotected_bits
    L_sparc_ldpc = L_sparc_ldpc_logM // logM
    L_unprotected = unprotected_bits // logM

    k = k_ldpc + unprotected_bits
    n = int(k / R)
    updated_rate = k / n
    L_sparc = k // logM
    R_sparc_ldpc = L_sparc_ldpc_logM / n

    lengths = ConcatLengths(k_ldpc=k_ldpc, mults=mults, L_unprotected=L_unprotected)
    return L_sparc, R_sparc_ldpc, L_sparc_ldpc, lengths, updated_rate
