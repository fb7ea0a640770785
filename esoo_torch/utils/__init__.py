from .config import (complex_dtype, precision_mode, real_dtype,
                     resolve_device, set_precision)

__all__ = ["complex_dtype", "precision_mode", "real_dtype",
           "resolve_device", "set_precision"]
