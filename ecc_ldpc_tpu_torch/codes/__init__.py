"""Host-side LDPC code construction and loading (NumPy only; port of
ecc_ldpc_tpu/codes)."""
from .registry import get_code, list_codes

__all__ = ["get_code", "list_codes"]
