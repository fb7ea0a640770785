"""esoo_torch: the PyTorch/CUDA port of esoo_tpu.

A second package beside the JAX reference (`esoo_tpu`), for one NVIDIA
H100.  Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas is a hand-written CUDA kernel under `csrc/`, built with nvcc at
first use (ops/_build.py).  The package imports neither JAX nor
`esoo_tpu`: it carries its own copies of the host-side table builders and
chemistry it needs.

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; asking for CUDA where there is none raises.
"""

import torch

# Chemistry energy functionals need full-f32 matmuls: reduced-precision
# (TF32) products move the OptOrb energy surface by ~3e-2 Ha, the same
# reason the JAX package forces "highest" matmul precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .orbital_optimization import (FusedOptOrbAdaptVQE,  # noqa: E402
                                   FusedOptOrbCASSCF,
                                   FusedOptOrbEigensolverResult,
                                   FusedOptOrbMCVQE, FusedOptOrbResult,
                                   FusedOptOrbSACASSCF, FusedOptOrbSSVQE,
                                   FusedOptOrbVQD, FusedOptOrbVQE)
from .sim import (UCC, UCCSD, HartreeFock, OccupationState,  # noqa: E402
                  SectorCI)

__version__ = "0.1.0"

__all__ = ["FusedOptOrbAdaptVQE", "FusedOptOrbCASSCF",
           "FusedOptOrbEigensolverResult", "FusedOptOrbMCVQE",
           "FusedOptOrbResult", "FusedOptOrbSACASSCF", "FusedOptOrbSSVQE",
           "FusedOptOrbVQD", "FusedOptOrbVQE", "HartreeFock",
           "OccupationState", "SectorCI", "UCC", "UCCSD"]
