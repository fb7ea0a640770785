"""Native (host C++) components and their ctypes loaders."""

from .loader import get_native_eri, native_available

__all__ = ["get_native_eri", "native_available"]
