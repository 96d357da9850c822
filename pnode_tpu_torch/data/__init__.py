from .loader import WindowedLoader
from .spectral import etdrk4_solve, generate_burgers_data, generate_ks_data

__all__ = ["WindowedLoader", "etdrk4_solve", "generate_burgers_data",
           "generate_ks_data"]
