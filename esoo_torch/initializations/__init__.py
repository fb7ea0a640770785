"""Determinant enumeration (host)."""

from .ci import enumerate_determinants, hf_determinant

__all__ = ["enumerate_determinants", "hf_determinant"]
