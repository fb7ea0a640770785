from .config import (check_same_device, complex_dtype, precision_mode,
                     real_dtype, resolve_device, same_device, set_precision)

__all__ = ["check_same_device", "complex_dtype", "precision_mode",
           "real_dtype", "resolve_device", "same_device", "set_precision"]
