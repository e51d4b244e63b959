"""Concatenated LDPC-SPARC codec: encoder + the full decoder family.

Redesign of sparc_sophie/sparc_new.py (L3). The reference's ~20
decoder variants are history-preserving copies of four families; here each
family is one implementation with options (BP schedule, Onsager mode,
posterior combination) — the design the SURVEY recommends (SURVEY.md
"Quirks", last bullet):

  sequential            AMP to convergence, then BP                (sparc_new.py:53-82)
  sequential_rerun      sequential + re-encode + second AMP        (sparc_new.py:84-113)
  naive                 1 AMP step + a few BP iters per step       (sparc_new.py:257-282)
  integrated            BP inside the AMP denoiser eta, Onsager
                        from the derivative of the BP-composed
                        denoiser                                   (sparc_new.py:472-502)

with ablations: onsager='none' (no_onsager_decoder, sparc_new.py:230-255),
posteriors=True (posterior combination instead of replacement,
sparc_new.py:411-439, 675-705).

The whole decode — AMP iterations, the probability bridges, and the batched
LDPC BP scan — is one jitted program: AMP soft outputs feed BP without host
round-trips (the BASELINE.json north star).

Amplitude convention: the reference's L3 stack carries amplitude
c = sqrt(n*P/L) inside beta and uses a dense Gaussian design with entries
N(0, 1/n) (sparc_new.py:1284-1294). Here the unified Hadamard design D of
ops/transforms.py has entries +-sqrt(P/L) acting on unit-amplitude vectors;
D = c * A_dense in distribution, so A v = D(v)/c and A^T z = D^T(z)/c —
the decoders below keep the reference's amplitude-carrying formulas with
that substitution.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SparcParams, LdpcParams, DecodeParams, ConcatLengths
from ..ops.transforms import SparcDesign
from ..ops.denoiser import mmse_denoise, map_estimate
from ..ops.bridges import (section_probs_to_bit_probs,
                           bit_probs_to_section_probs, combine_posteriors,
                           integrated_onsager_derivative, bit0_mask_np)
from ..ops.bp import bp_decode
from ..utils import bits as bitops
from ..utils import rng as rngmod
from .ldpc import LdpcCode, get_code


DECODERS = ("amp_only", "sequential", "sequential_rerun", "naive",
            "naive_posteriors", "no_onsager", "integrated",
            "integrated_posteriors")


class ConcatCodec:
    """Concatenated LDPC-SPARC code over a shared Hadamard design."""

    def __init__(self, sparc_params: SparcParams, ldpc_params: LdpcParams,
                 lengths: ConcatLengths, ldpc_protected: bool = True):
        self.sparc = sparc_params
        self.ldpc_params = ldpc_params
        self.lengths = lengths
        self.ldpc_protected = ldpc_protected
        self.code: LdpcCode = get_code(ldpc_params.standard, ldpc_params.rate,
                                       ldpc_params.z, ldpc_params.ptype)
        p = sparc_params
        self.logM = p.logM
        if ldpc_protected:
            self.unprotected_bit_len = lengths.L_unprotected * self.logM
            self.user_bits_len = lengths.k_ldpc + self.unprotected_bit_len
        else:
            self.unprotected_bit_len = 0
            self.user_bits_len = p.L * self.logM
        self.encoded_bit_len = p.L * self.logM
        # n follows the L3 convention n = encoded_bits / R
        # (sparc_new.py:44, no SC row rounding at L3)
        self.n = int(self.encoded_bit_len / p.R)
        self.c_amp = float(np.sqrt(self.n * p.P / p.L))  # sqrt(n*P/L)

    # ------------------------------------------------------------------
    # encode (sparc_ldpc_encode, sparc_new.py:15-51)
    # ------------------------------------------------------------------
    def build_design(self, seed) -> SparcDesign:
        W = np.array([[self.sparc.P]])
        return SparcDesign.build(W, self.sparc.L, self.sparc.M, self.n, seed)

    def encode_ldpc_bits(self, user_bits: jnp.ndarray) -> jnp.ndarray:
        """user bits -> (unprotected prefix || LDPC codewords)
        (encode_ldpc, sparc_new.py:1343-1359)."""
        u = self.unprotected_bit_len
        unprotected = user_bits[:u]
        info = user_bits[u:].reshape(self.lengths.mults, self.code.K)
        coded = self.code.encode(info).reshape(-1)
        return jnp.concatenate([jnp.asarray(unprotected, coded.dtype), coded])

    def encode_message(self, key: jax.Array):
        """Traceable message path: random user bits -> LDPC encode ->
        amplitude-carrying message vector. Returns (user_bits, total_bits,
        beta0)."""
        user_bits = bitops.random_bits(
            rngmod.derive(key, rngmod.BITS), self.user_bits_len).astype(jnp.int32)
        if self.ldpc_protected:
            total_bits = self.encode_ldpc_bits(user_bits)
        else:
            total_bits = user_bits
        assert total_bits.size == self.encoded_bit_len
        beta0 = bitops.bits_to_msg_vector(total_bits.astype(bool),
                                          self.sparc.M, 1,
                                          amplitude=self.c_amp)
        return user_bits, total_bits, beta0

    def encode(self, seed, key: Optional[jax.Array] = None):
        """Returns (user_bits, total_bits, beta0, x, design)."""
        if key is None:
            key = rngmod.root_key(seed)
        user_bits, total_bits, beta0 = self.encode_message(key)
        design = self.build_design(seed)
        x = design.ab(beta0 / self.c_amp)  # A beta0 = D(beta0)/c
        return user_bits, total_bits, beta0, x, design

    # ------------------------------------------------------------------
    # shared decoder building blocks
    # ------------------------------------------------------------------
    def _amp_step(self, design, y, beta, z, tau_sqr, onsager="standard",
                  deta_sum=None):
        """One L3-convention AMP iteration (sparc_amp_single_it,
        sparc_new.py:975-990 / integrated z-update, sparc_new.py:492-494).

        onsager: 'standard'  (z/tau^2)(P - |beta|^2/n)
                 'none'      0                       (amp_no_onsager, :1015-1028)
                 'deta'      (z/n) * deta_sum        (integrated, :492)
        Returns (z, s, tau_sqr).
        """
        n, P = self.n, self.sparc.P
        Ab = design.ab(beta / self.c_amp)
        if onsager == "standard":
            corr = (z / tau_sqr) * (P - jnp.sum(beta ** 2) / n)
        elif onsager == "none":
            corr = 0.0
        else:  # 'deta'
            corr = (z / n) * deta_sum
        z = y - Ab + corr
        s = design.az(z) / self.c_amp + beta
        tau_sqr = jnp.sum(z ** 2) / n
        return z, s, tau_sqr

    def _mmse(self, s, tau_sqr, return_probs=False):
        """L3 amplitude-carrying MMSE (msg_vector_mmse_estimator,
        sparc_new.py:1040-1066): c * softmax(c * s / tau^2) per section."""
        out = mmse_denoise(s, self.c_amp / tau_sqr, self.sparc.M, 1,
                           return_probs=return_probs)
        if return_probs:
            beta, probs = out
            return self.c_amp * beta, probs.reshape(s.shape)
        return self.c_amp * out

    def _map(self, s):
        return self.c_amp * map_estimate(s, self.sparc.M, 1)

    def ldpc_bp(self, bit_probs: jnp.ndarray, num_its: int,
                hard: bool):
        """Blockwise BP over P(bit=0) probabilities (ldpc_bp,
        sparc_new.py:1162-1193). Returns posterior probs (hard=False) or
        hard user-bit decisions, first K of each block (hard=True).

        The clipping epsilon is float32-safe (1e-7, not the reference's
        1e-15 which rounds 1-eps to 1.0 in f32 and yields infinite LLRs)."""
        eps = 1e-7
        p = jnp.clip(bit_probs, eps, 1 - eps)
        llr = jnp.log(p) - jnp.log1p(-p)
        nblocks = llr.size // self.code.N
        # This call sits inside the PER-TRIAL decode, so under a
        # Monte-Carlo vmap each trial decodes only its own few blocks
        # (mults=4 at the reference's z=150 config). Monte-Carlo batches
        # use decode_batch/ldpc_bp_batch, which PACK all trials' blocks
        # into one BP call instead.
        res = bp_decode(llr.reshape(nblocks, self.code.N).astype(jnp.float32),
                        self.code.graph, max_iters=num_its, method="sumprod")
        app = res.app
        if hard:
            return (app[:, :self.code.K] < 0).astype(jnp.int32).reshape(-1)
        return jax.nn.sigmoid(app).reshape(-1)  # exp(app)/(1+exp(app))

    def _split_protected(self, v, per_section):
        u = self.lengths.L_unprotected * per_section
        return v[:u], v[u:]

    # ------------------------------------------------------------------
    # decoder family
    # ------------------------------------------------------------------
    def decode(self, y: jnp.ndarray, design: SparcDesign,
               decode_params: DecodeParams, decoder: str = "sequential",
               bp_inner_iters: int = 6, bp_final_iters: int = 200):
        assert decoder in DECODERS
        if self.ldpc_protected and self.lengths.L_unprotected:
            # semi-protected messages: supported by the sequential decoder
            # (as in the reference, sparc_new.py:66-71) and our interleaved
            # extension; the integrated/rerun families require a fully
            # protected message (they do in the reference too).
            assert decoder in ("amp_only", "sequential", "naive",
                               "naive_posteriors", "no_onsager"), (
                f"decoder {decoder!r} requires a fully protected message "
                f"(L_unprotected={self.lengths.L_unprotected})")
        fn = {
            "amp_only": self._decode_amp_only,
            "sequential": self._decode_sequential,
            "sequential_rerun": self._decode_sequential_rerun,
            "naive": functools.partial(self._decode_interleaved,
                                       onsager="standard", posteriors=False),
            "naive_posteriors": functools.partial(self._decode_interleaved,
                                                  onsager="standard",
                                                  posteriors=True),
            "no_onsager": functools.partial(self._decode_interleaved,
                                            onsager="none", posteriors=False),
            "integrated": functools.partial(self._decode_integrated,
                                            posteriors=False),
            "integrated_posteriors": functools.partial(self._decode_integrated,
                                                       posteriors=True),
        }[decoder]
        return fn(y, design, decode_params, bp_inner_iters, bp_final_iters)

    # ------------------------------------------------------------------
    # batched decode with cross-trial BP lane packing
    # ------------------------------------------------------------------
    def ldpc_bp_batch(self, bit_probs: jnp.ndarray, num_its: int,
                      hard: bool):
        """`ldpc_bp` over a leading trial axis with every trial's blocks
        PACKED into one BP invocation: (B, nbits) -> one (B*mults, N)
        kernel call instead of B vmapped mults-codeword calls (mults=4 at
        the reference's z=150 config)."""
        B = bit_probs.shape[0]
        eps = 1e-7
        p = jnp.clip(bit_probs, eps, 1 - eps)
        llr = jnp.log(p) - jnp.log1p(-p)
        nblocks = llr.size // self.code.N
        res = bp_decode(llr.reshape(nblocks, self.code.N).astype(jnp.float32),
                        self.code.graph, max_iters=num_its, method="sumprod")
        app = res.app.reshape(B, -1, self.code.N)
        if hard:
            return (app[:, :, :self.code.K] < 0).astype(jnp.int32) \
                .reshape(B, -1)
        return jax.nn.sigmoid(app).reshape(B, -1)

    def decode_batch(self, ys: jnp.ndarray, designs: SparcDesign,
                     decode_params: DecodeParams, decoder: str = "sequential",
                     bp_inner_iters: int = 6, bp_final_iters: int = 200):
        """Batched decode of B trials with cross-trial BP lane packing.

        Per-trial results are BIT-IDENTICAL to `vmap(decode)`: the AMP
        side runs the same per-trial code under vmap; only the BP calls
        are restructured to run once per (AMP-)iteration over all
        B*mults blocks. Gated bitwise on the CPU
        (tests/test_concat.py::test_decode_batch_matches_vmap) and on the
        GPU at the z=150 config by the concat phase of chip_smoke.py.

        ys: (B, n). designs: stacked SparcDesign (leading batch axis on
        idx/signs, one design per trial). Returns (B, user_bits_len)."""
        assert decoder in DECODERS
        dp, bi, bf = decode_params, bp_inner_iters, bp_final_iters
        if decoder in ("amp_only", "sequential_rerun") \
                or not self.ldpc_protected:
            # no BP (amp_only) / double-AMP rerun (not perf-relevant):
            # plain per-trial vmap. The stacked design's batch axis lives
            # on idx/signs only (scale is config-static), so vmap those
            # leaves and rebuild per trial (the montecarlo convention).
            return jax.vmap(lambda y, i, g: self.decode(
                y, designs.with_leaves(i, g), dp, decoder, bi, bf))(
                ys, designs.idx, designs.signs)
        if self.lengths.L_unprotected:
            assert decoder in ("sequential", "naive", "naive_posteriors",
                               "no_onsager"), (
                f"decoder {decoder!r} requires a fully protected message")
        if decoder == "sequential":
            return self._decode_sequential_batch(ys, designs, dp, bf)
        if decoder in ("naive", "naive_posteriors", "no_onsager"):
            return self._decode_interleaved_batch(
                ys, designs, dp, bi, bf,
                onsager="none" if decoder == "no_onsager" else "standard",
                posteriors=decoder == "naive_posteriors")
        return self._decode_integrated_batch(
            ys, designs, dp, bi, bf,
            posteriors=decoder == "integrated_posteriors")

    def _decode_sequential_batch(self, ys, designs, dp, bf):
        M = self.sparc.M
        beta, s = jax.vmap(lambda y, i, g: self._run_amp(
            y, designs.with_leaves(i, g), dp.t_max))(
            ys, designs.idx, designs.signs)
        u = self.lengths.L_unprotected * M if self.ldpc_protected else 0
        un_beta, prot_beta = beta[:, :u], beta[:, u:]
        bit_probs = jax.vmap(
            lambda b: section_probs_to_bit_probs(b / self.c_amp, M))(prot_beta)
        prot_bits = self.ldpc_bp_batch(bit_probs, bf, hard=True)
        if u:
            un_bits = jax.vmap(
                lambda ss: bitops.msg_vector_to_bits(self._map(ss)[:u], M))(
                s).astype(jnp.int32)
            return jnp.concatenate([un_bits, prot_bits], axis=1)
        return prot_bits

    def _decode_interleaved_batch(self, ys, designs, dp, bi, bf, *, onsager,
                                  posteriors):
        M = self.sparc.M
        B = ys.shape[0]
        u_sec = self.lengths.L_unprotected * M if self.ldpc_protected else 0
        amp_step = jax.vmap(lambda i, g, y, beta, z, tau: self._amp_step(
            designs.with_leaves(i, g), y, beta, z, tau, onsager=onsager))
        mmse = jax.vmap(self._mmse)
        to_bits = jax.vmap(lambda b: section_probs_to_bit_probs(b, M))
        to_secs = jax.vmap(lambda p: bit_probs_to_section_probs(p, M))

        def body(carry, _):
            beta, z, tau_sqr = carry
            z, s, tau_sqr = amp_step(designs.idx, designs.signs, ys,
                                     beta, z, tau_sqr)
            beta = mmse(s, tau_sqr)
            un_beta, prot_beta = beta[:, :u_sec], beta[:, u_sec:]
            bit_probs = to_bits(prot_beta / self.c_amp)
            post = self.ldpc_bp_batch(bit_probs, bi, hard=False)
            gamma = to_secs(post)
            if posteriors:
                alpha = prot_beta / self.c_amp
                prot_new = self.c_amp * jax.vmap(
                    lambda a, g: combine_posteriors(a, g, M))(alpha, gamma)
            else:
                prot_new = self.c_amp * gamma
            beta = jnp.concatenate([un_beta, prot_new], axis=1)
            return (beta, z, tau_sqr), None

        init = (jnp.zeros((B, self.sparc.L * M), jnp.float32),
                jnp.zeros_like(ys), jnp.ones((B,), jnp.float32))
        (beta, z, tau_sqr), _ = jax.lax.scan(body, init, None,
                                             length=dp.t_max - 1)
        z, s, tau_sqr = amp_step(designs.idx, designs.signs, ys, beta, z,
                                 tau_sqr)
        beta = mmse(s, tau_sqr)
        bit_probs = to_bits(beta[:, u_sec:] / self.c_amp)
        prot_bits = self.ldpc_bp_batch(bit_probs, bf, hard=True)
        if u_sec:
            un_map = jax.vmap(self._map)(s)[:, :u_sec]
            un_bits = jax.vmap(
                lambda v: bitops.msg_vector_to_bits(v, M))(un_map) \
                .astype(jnp.int32)
            return jnp.concatenate([un_bits, prot_bits], axis=1)
        return prot_bits

    def _decode_integrated_batch(self, ys, designs, dp, bi, bf, *,
                                 posteriors):
        M = self.sparc.M
        L = self.sparc.L
        B = ys.shape[0]
        amp_step = jax.vmap(lambda i, g, y, beta, z, tau, ds: self._amp_step(
            designs.with_leaves(i, g), y, beta, z, tau, onsager="deta",
            deta_sum=ds))
        mmse = jax.vmap(self._mmse)
        to_bits = jax.vmap(lambda b: section_probs_to_bit_probs(b, M))
        to_secs = jax.vmap(lambda p: bit_probs_to_section_probs(p, M))

        def body(carry, _):
            beta, z, tau_sqr, deta_sum = carry
            z, s, tau_sqr = amp_step(designs.idx, designs.signs, ys,
                                     beta, z, tau_sqr, deta_sum)
            weighted_alpha = mmse(s, tau_sqr)
            alpha = weighted_alpha / self.c_amp
            vk0 = to_bits(alpha)
            vk = self.ldpc_bp_batch(vk0, bi, hard=False)
            gamma = to_secs(vk)
            if posteriors:
                beta_probs = jax.vmap(
                    lambda a, g: combine_posteriors(a, g, M))(alpha, gamma)
                beta = self.c_amp * beta_probs
                deta = jax.vmap(lambda a, g, v, v0, t: self._deta_posteriors(
                    a, g, v, v0, t, M))(alpha, gamma, vk, vk0, tau_sqr)
            else:
                beta = self.c_amp * gamma
                deta = jax.vmap(
                    lambda a, v, v0, g, t: self.c_amp *
                    integrated_onsager_derivative(a, v, v0, g, t, M,
                                                  self.c_amp))(
                    alpha, vk, vk0, gamma, tau_sqr)
            return (beta, z, tau_sqr, jnp.sum(deta, axis=1)), None

        init = (jnp.zeros((B, L * M), jnp.float32), jnp.zeros_like(ys),
                jnp.ones((B,), jnp.float32), jnp.zeros((B,), jnp.float32))
        (beta, z, tau_sqr, deta_sum), _ = jax.lax.scan(body, init, None,
                                                       length=dp.t_max - 1)
        z, s, tau_sqr = amp_step(designs.idx, designs.signs, ys, beta, z,
                                 tau_sqr, deta_sum)
        weighted_alpha = mmse(s, tau_sqr)
        vk0 = to_bits(weighted_alpha / self.c_amp)
        return self.ldpc_bp_batch(vk0, bf, hard=True)

    def _run_amp(self, y, design, t_max):
        """Full L3 AMP (sparc_amp, sparc_new.py:885-912): fixed t_max
        iterations, scalar tau, returns (beta_mmse, s)."""
        def body(carry, t):
            beta, z, tau_sqr, _ = carry
            first = t == 0
            # reference: z = y at t=0, Onsager skipped
            Ab = design.ab(beta / self.c_amp)
            corr = (z / tau_sqr) * (self.sparc.P - jnp.sum(beta ** 2) / self.n)
            z = jnp.where(first, y, y - Ab + corr)
            s = design.az(z) / self.c_amp + beta
            tau_sqr = jnp.sum(z ** 2) / self.n
            beta = self._mmse(s, tau_sqr)
            # s rides the carry (only the final iteration's is needed) —
            # stacking every iteration would cost O(t_max * LM) per trial
            # under the Monte-Carlo vmap
            return (beta, z, tau_sqr, s), None
        LM = self.sparc.L * self.sparc.M
        init = (jnp.zeros(LM, jnp.float32), jnp.zeros_like(y),
                jnp.asarray(1.0, jnp.float32), jnp.zeros(LM, jnp.float32))
        (beta, _, _, s), _ = jax.lax.scan(body, init, jnp.arange(t_max))
        return beta, s

    def _decode_amp_only(self, y, design, dp, bi, bf):
        """Plain SPARC decode in the L3 convention (the ldpc_bool=False path
        of sparc_ldpc_decode, sparc_new.py:78-81)."""
        _, s = self._run_amp(y, design, dp.t_max)
        beta_map = self._map(s)
        return bitops.msg_vector_to_bits(beta_map, self.sparc.M).astype(jnp.int32)

    def _decode_sequential(self, y, design, dp, bi, bf):
        """AMP to completion, then BP (sparc_ldpc_decode, sparc_new.py:53-82)."""
        M = self.sparc.M
        beta, s = self._run_amp(y, design, dp.t_max)
        un_beta, prot_beta = self._split_protected(beta, M)
        unprotected = self._map(s)[:un_beta.size]
        un_bits = bitops.msg_vector_to_bits(unprotected, M) \
            if un_beta.size else jnp.zeros(0, jnp.bool_)
        bit_probs = section_probs_to_bit_probs(prot_beta / self.c_amp, M)
        prot_bits = self.ldpc_bp(bit_probs, bf, hard=True)
        return jnp.concatenate([un_bits.astype(jnp.int32), prot_bits])

    def _decode_sequential_rerun(self, y, design, dp, bi, bf):
        """AMP -> soft BP -> re-encode -> AMP -> MAP (sparc_ldpc_decode_loop,
        sparc_new.py:84-113; the reference's chunk[c.K] indexing bug at :109
        is fixed to chunk[:K] here)."""
        M = self.sparc.M
        beta, _ = self._run_amp(y, design, dp.t_max)
        bit_probs = section_probs_to_bit_probs(beta / self.c_amp, M)
        post = self.ldpc_bp(bit_probs, bf, hard=False)
        beta_bp = self.c_amp * bit_probs_to_section_probs(post, M)
        new_y = design.ab(beta_bp / self.c_amp)
        _, s2 = self._run_amp(new_y, design, dp.t_max)
        hard = self._map(s2)
        ldpc_bits = bitops.msg_vector_to_bits(hard, M).astype(jnp.int32)
        blocks = ldpc_bits.reshape(-1, self.code.N)
        return blocks[:, :self.code.K].reshape(-1)

    def _decode_interleaved(self, y, design, dp, bi, bf, *, onsager,
                            posteriors):
        """1 AMP step + `bi` BP iterations per step, final `bf`-iteration BP
        (naively_integrated_decoder, sparc_new.py:257-282; posteriors variant
        :411-439; Onsager-free :230-255).

        Semi-protected extension (beyond the reference, whose interleaved
        decoders assume a fully protected message): BP runs only on the
        protected section suffix; the unprotected prefix keeps its MMSE
        estimate per step and is MAP-decided at the end, like the sequential
        decoder's handling (sparc_new.py:66-71).

        The t_max-1 soft iterations are a `lax.scan` (compile time flat in
        t_max; the reference unrolls its Python loop, sparc_new.py:257-282)
        with the final hard-decision iteration peeled."""
        M = self.sparc.M
        u_sec = self.lengths.L_unprotected * M if self.ldpc_protected else 0

        def body(carry, _):
            beta, z, tau_sqr = carry
            z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                           onsager=onsager)
            beta = self._mmse(s, tau_sqr)
            un_beta, prot_beta = beta[:u_sec], beta[u_sec:]
            bit_probs = section_probs_to_bit_probs(prot_beta / self.c_amp, M)
            post = self.ldpc_bp(bit_probs, bi, hard=False)
            gamma = bit_probs_to_section_probs(post, M)
            if posteriors:
                alpha = prot_beta / self.c_amp
                prot_new = self.c_amp * combine_posteriors(alpha, gamma, M)
            else:
                prot_new = self.c_amp * gamma
            beta = jnp.concatenate([un_beta, prot_new])
            return (beta, z, tau_sqr), None

        init = (jnp.zeros(self.sparc.L * M, jnp.float32), jnp.zeros_like(y),
                jnp.asarray(1.0, jnp.float32))
        (beta, z, tau_sqr), _ = jax.lax.scan(body, init, None,
                                             length=dp.t_max - 1)
        # peeled final iteration: AMP step, then the bf-iteration hard BP
        z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                       onsager=onsager)
        beta = self._mmse(s, tau_sqr)
        bit_probs = section_probs_to_bit_probs(beta[u_sec:] / self.c_amp, M)
        prot_bits = self.ldpc_bp(bit_probs, bf, hard=True)
        if u_sec:
            un_map = self._map(s)[:u_sec]
            un_bits = bitops.msg_vector_to_bits(un_map, M).astype(jnp.int32)
            return jnp.concatenate([un_bits, prot_bits])
        return prot_bits

    def _decode_integrated(self, y, design, dp, bi, bf, *, posteriors):
        """BP inside the AMP denoiser with the generalized Onsager term from
        the derivative of the BP-composed denoiser (integrated_decoder,
        sparc_new.py:472-502; eta 4-step pipeline :709-735; posteriors
        variant :675-705, :793-822, :843-869).

        The t_max-1 eta iterations are a `lax.scan` (compile time flat in
        t_max; the reference unrolls, sparc_new.py:489) with the final
        hard-decision iteration peeled."""
        M = self.sparc.M
        L = self.sparc.L

        def body(carry, _):
            beta, z, tau_sqr, deta_sum = carry
            z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                           onsager="deta", deta_sum=deta_sum)
            # eta: MMSE -> bit probs -> BP -> section estimate
            weighted_alpha = self._mmse(s, tau_sqr)
            alpha = weighted_alpha / self.c_amp
            vk0 = section_probs_to_bit_probs(alpha, M)
            vk = self.ldpc_bp(vk0, bi, hard=False)
            gamma = bit_probs_to_section_probs(vk, M)
            if posteriors:
                beta_probs = combine_posteriors(alpha, gamma, M)
                beta = self.c_amp * beta_probs
                deta = self._deta_posteriors(alpha, gamma, vk, vk0,
                                             tau_sqr, M)
            else:
                beta = self.c_amp * gamma
                deta = self.c_amp * integrated_onsager_derivative(
                    alpha, vk, vk0, gamma, tau_sqr, M, self.c_amp)
            return (beta, z, tau_sqr, jnp.sum(deta)), None

        init = (jnp.zeros(L * M, jnp.float32), jnp.zeros_like(y),
                jnp.asarray(1.0, jnp.float32), jnp.asarray(0.0, jnp.float32))
        (beta, z, tau_sqr, deta_sum), _ = jax.lax.scan(body, init, None,
                                                       length=dp.t_max - 1)
        # peeled final iteration: AMP step, MMSE, bf-iteration hard BP
        z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                       onsager="deta", deta_sum=deta_sum)
        weighted_alpha = self._mmse(s, tau_sqr)
        vk0 = section_probs_to_bit_probs(weighted_alpha / self.c_amp, M)
        return self.ldpc_bp(vk0, bf, hard=True)

    # ------------------------------------------------------------------
    # instrumentation (the reference's *_test decoder family)
    # ------------------------------------------------------------------
    def ldpc_bp_traced(self, bit_probs: jnp.ndarray, num_its: int):
        """Blockwise BP returning the posterior P(bit=0) after EVERY BP
        iteration: (num_its, nbits). Per-BP-iteration probe semantics of the
        reference's schedule-debugging instrumentation (ldpc_bp_test,
        sparc_new.py:1195-1232)."""
        from ..ops.bp import bp_decode_trace
        eps = 1e-7
        p = jnp.clip(bit_probs, eps, 1 - eps)
        llr = jnp.log(p) - jnp.log1p(-p)
        nblocks = llr.size // self.code.N
        traj, _ = bp_decode_trace(
            llr.reshape(nblocks, self.code.N).astype(jnp.float32),
            self.code.graph, num_iters=num_its, method="sumprod")
        return jax.nn.sigmoid(traj).reshape(num_its, -1)

    def decode_instrumented(self, y, design, decode_params,
                            decoder: str = "naive", bp_inner_iters: int = 6,
                            trace_inner_bp: bool = False):
        """Per-iteration user-bit BER probes.

        One implementation replaces the reference's ~8 hand-copied
        instrumented variants (naively_integrated_test_2/3/4,
        integrated_decoder_test/_2, sparc_new.py:314-409,573-641): at every
        AMP iteration, record hard user-bit decisions (a) after the MMSE
        step ('pre_bp') and (b) after the inner BP pass ('post_bp'). With
        trace_inner_bp=True, also record decisions after EVERY BP iteration
        within each AMP iteration ('inner_bp', the per-BP-iteration probes
        of ldpc_bp_test, sparc_new.py:1195-1232).

        The probe loop is a `lax.scan` over AMP iterations; returns a dict
        with 'pre_bp'/'post_bp' (t_max, user_bits) and, when traced,
        'inner_bp' (t_max, bp_inner_iters, user_bits).
        """
        assert decoder in ("naive", "no_onsager", "integrated")
        M = self.sparc.M
        dp = decode_params

        def body(carry, _):
            beta, z, tau_sqr, deta_sum = carry
            if decoder == "integrated":
                z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                               onsager="deta",
                                               deta_sum=deta_sum)
            else:
                ons = "none" if decoder == "no_onsager" else "standard"
                z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                               onsager=ons)
            weighted_alpha = self._mmse(s, tau_sqr)
            alpha = weighted_alpha / self.c_amp
            vk0 = section_probs_to_bit_probs(alpha, M)
            pre = self._hard_user_bits(vk0)
            if trace_inner_bp:
                traj = self.ldpc_bp_traced(vk0, bp_inner_iters)
                vk = traj[-1]
                inner = jax.vmap(self._hard_user_bits)(traj)
            else:
                vk = self.ldpc_bp(vk0, bp_inner_iters, hard=False)
                inner = None
            post = self._hard_user_bits(vk)
            gamma = bit_probs_to_section_probs(vk, M)
            beta = self.c_amp * gamma
            if decoder == "integrated":
                deta = self.c_amp * integrated_onsager_derivative(
                    alpha, vk, vk0, gamma, tau_sqr, M, self.c_amp)
                deta_sum = jnp.sum(deta)
            probes = (pre, post) if inner is None else (pre, post, inner)
            return (beta, z, tau_sqr, deta_sum), probes

        init = (jnp.zeros(self.sparc.L * M, jnp.float32), jnp.zeros_like(y),
                jnp.asarray(1.0, jnp.float32), jnp.asarray(0.0, jnp.float32))
        _, probes = jax.lax.scan(body, init, None, length=dp.t_max)
        out = {"pre_bp": probes[0], "post_bp": probes[1]}
        if trace_inner_bp:
            out["inner_bp"] = probes[2]
        return out

    def _hard_user_bits(self, bit_probs):
        """P(bit=0) probabilities -> hard user-bit decisions (first K of
        each LDPC block; ldpc_probs_to_user_bits, sparc_new.py:1234-1246)."""
        blocks = bit_probs.reshape(-1, self.code.N)
        return (blocks[:, :self.code.K] < 0.5).astype(jnp.int32).reshape(-1)

    def _deta_posteriors(self, alpha, gamma, vk, vk0, tau_sqr, M):
        """Quotient-rule derivative for the posterior-combining eta
        (differentiated_eta_calc_posteriors, sparc_new.py:843-869)."""
        c = self.c_amp
        L = alpha.shape[-1] // M
        main = integrated_onsager_derivative(
            alpha, vk, vk0, jnp.ones_like(alpha), tau_sqr, M, c)
        alpha_dash = alpha * (c / tau_sqr) * (1.0 - alpha)
        gamma_dash = gamma * main
        top = (alpha * gamma).reshape(L, M)
        # floor the normalizer: in f32 a near-zero section mass would blow up
        # the quotient rule (the reference ran in f64 without a floor)
        bot = jnp.maximum(jnp.sum(top, axis=1, keepdims=True), 1e-12)
        top_dash = (alpha_dash * gamma + alpha * gamma_dash).reshape(L, M)
        bot_dash = jnp.sum(top_dash, axis=1, keepdims=True)
        eta_dash = c * (top_dash * bot - top * bot_dash) / (bot ** 2)
        return eta_dash.reshape(alpha.shape)


# --------------------------------------------------------------------------
# end-to-end simulation (sparc_sim_new.py:12-224 family)
# --------------------------------------------------------------------------

# LRU-bounded: each entry holds a jitted program; sweeping many configs in
# one process must not grow device/host memory without bound
_SIM_CACHE_MAX = 16
_SIM_CACHE = {}


def concat_sim(sparc_params: SparcParams, ldpc_params: LdpcParams,
               lengths: ConcatLengths, ldpc_protected: bool,
               decode_params: DecodeParams, awgn_var: float, seed,
               decoder: str = "sequential") -> dict:
    """One concatenated-code trial: encode -> AWGN -> decode -> BER.

    The whole trial (LDPC encode, SPARC spreading, channel, AMP+BP decode)
    is one jitted device program per configuration — AMP soft outputs feed
    BP without host round-trips (the BASELINE.json north star).
    """
    from .sparc import awgn_channel
    from ..utils.metrics import bit_error_rate

    codec = ConcatCodec(sparc_params, ldpc_params, lengths, ldpc_protected)
    cfg = (sparc_params, ldpc_params, lengths, ldpc_protected, decode_params,
           decoder)
    if cfg not in _SIM_CACHE:
        def trial(key, design, awgn_var):
            user_bits, total_bits, beta0 = codec.encode_message(key)
            x = design.ab(beta0 / codec.c_amp)
            y = awgn_channel(x, awgn_var,
                             rngmod.derive(key, rngmod.CHANNEL))
            bits_out = codec.decode(y, design, decode_params, decoder)
            return user_bits, bits_out

        if len(_SIM_CACHE) >= _SIM_CACHE_MAX:
            _SIM_CACHE.pop(next(iter(_SIM_CACHE)))  # evict least recent
        _SIM_CACHE[cfg] = (codec, jax.jit(trial))
    # true LRU: refresh recency on hit, so round-robining more than
    # _SIM_CACHE_MAX configs doesn't evict exactly the next one needed
    codec, trial_fn = _SIM_CACHE.pop(cfg)
    _SIM_CACHE[cfg] = (codec, trial_fn)
    key = rngmod.root_key(seed)
    design = codec.build_design(seed)
    user_bits, bits_out = trial_fn(key, design, jnp.float32(awgn_var))
    ber = bit_error_rate(user_bits, bits_out)
    return {"ber": ber, "bits_in": user_bits, "bits_out": bits_out}
