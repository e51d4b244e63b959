"""ldpc_sparc_tpu: a JAX framework for Sparse Regression Codes (SPARCs),
IEEE 802.11n/802.16 LDPC codes, and their concatenation.

Built from scratch in JAX/XLA with the capabilities of the reference
repo SophieLangdon27/LDPC_SPARC (see SURVEY.md for the component inventory and
file:line parity citations throughout the package).

Layering (idiomatic JAX, not a translation of the reference's layout):
  ops/       compute kernels: Hadamard design transforms, denoisers,
             LDPC belief propagation, AMP<->BP probability bridges
  models/    codecs: SPARC (AMP), state evolution, LDPC code library,
             concatenated LDPC-SPARC decoder family
  parallel/  device-mesh sharding, Monte-Carlo fan-out, collectives
  utils/     bit codecs, RNG derivation, error metrics
  io/        resumable results store, campaign logs, plotting helpers
  native/    C++ CPU oracle for the BP kernel (ctypes)
"""

from .config import (SparcParams, DecodeParams, LdpcParams, ConcatLengths,
                     param_calc, param_calc_semi_protected)
from .ops.transforms import SparcDesign
from .models.sparc import (sparc_encode, sparc_decode, sparc_sim,
                           amp_decode, awgn_channel)
from .models.state_evolution import sparc_se

__version__ = "0.1.0"
