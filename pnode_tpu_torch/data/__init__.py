from .spectral import etdrk4_solve, generate_burgers_data, generate_ks_data

__all__ = ["etdrk4_solve", "generate_burgers_data", "generate_ks_data"]
