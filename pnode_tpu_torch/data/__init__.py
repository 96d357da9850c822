from .spectral import etdrk4_solve, generate_ks_data

__all__ = ["etdrk4_solve", "generate_ks_data"]
