from .config import (Precision, check_same_device, complex_dtype,
                     precision_mode, real_dtype, resolve_device, same_device,
                     set_precision)
from .debug import (check_imaginary_residue, check_partial_unitary,
                    check_rdm_sanity, nan_checks)
from .profiling import PhaseTimer, annotate, trace_to

__all__ = ["Precision", "check_same_device", "complex_dtype", "precision_mode",
           "real_dtype", "resolve_device", "same_device", "set_precision",
           "check_imaginary_residue", "check_partial_unitary",
           "check_rdm_sanity", "nan_checks",
           "PhaseTimer", "annotate", "trace_to"]
