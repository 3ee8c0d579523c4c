from .hashing import hash_64
from .ksort import ks_introsort
from .rand48 import Rand48

__all__ = ["hash_64", "ks_introsort", "Rand48"]
